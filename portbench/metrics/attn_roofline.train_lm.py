"""Causal attention's share of its roofline in training, in %: the
least time of the traced flash launches (forward, dq, dk/dv at the
cell's batch, sequence, heads and head size, from the visible pairs,
``frozen.flash_bound_ms`` / ``flash_bwd_bound_ms``) over their device
time.  The kernels are found by these names."""

from portbench import frozen
from portbench.readers import roofline

KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def read(run):
    cfg, tr = run["config"], run["traffic"]
    h = cfg["num_attention_heads"]
    shape = (tr["batch"], tr["sequence_length"], tr["sequence_length"], h,
             cfg["hidden_size"] // h, True, cfg["dtype"])

    def bound_ms(key):
        if key == "flash_fwd":
            return frozen.flash_bound_ms(*shape)[0]
        return frozen.flash_bwd_bound_ms(key, *shape)[0]

    return roofline(run, KERNELS, bound_ms)
