"""Host-side utilities of the port: own copies of what the engine,
the node runtime and the decode tier call."""

from tensorflowonspark_tpu_torch.utils.hostinfo import (  # noqa: F401
    clear_child_pids,
    get_ip_address,
    kill_pid,
    read_child_pids,
    read_executor_id,
    reap_child,
    single_node_env,
    track_child_pid,
    write_executor_id,
)
