from ray_tpu_torch.workflow.api import (
    WorkflowCancelledError, cancel, delete, get_output, get_status,
    list_all, resume, run, run_async, send_event, step, wait_for_event)
