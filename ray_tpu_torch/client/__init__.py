"""Remote-driver client mode ("ray://" addresses).

Equivalent of the reference's Ray Client (`python/ray/util/client/`,
`ray_client.proto:325`): a thin client outside the cluster speaks a
request/response protocol to a client server co-located with the cluster,
which executes every API call in a real driver. `ray_tpu_torch.init(
address="ray://host:port")` routes here; the rest of the public API
(`remote/get/put/wait`, actors, placement groups, state) is unchanged.
"""

from ray_tpu_torch.client.client import ClientWorker, connect
from ray_tpu_torch.client.server import ClientServer

__all__ = ["ClientWorker", "ClientServer", "connect"]
