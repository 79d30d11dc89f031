from ray_tpu_torch.serve.api import (
    deployment,
    run,
    shutdown,
    status,
    delete,
    get_deployment_handle,
    reconfigure,
    start_http_proxy,
    start_http_proxies_per_node,
    start_grpc_proxy,
    start_rpc_proxy,
    router_stats,
    reset_router_stats,
    AutoscalingConfig,
    Deployment,
    DeploymentHandle,
)
from ray_tpu_torch.serve.config import (
    ServeConfig,
    deploy_config_file,
    get_serve_config,
    load_config,
    set_serve_config,
)
from ray_tpu_torch.serve.ingress import App, Request, RouteNotFound, ingress
from ray_tpu_torch.serve.batching import batch
