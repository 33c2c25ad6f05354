"""Models: device ms a step in elementwise kernels (``trace.group`` "other")
of every region but the optimizer, the head and loss and the layer norms
(``gpt.embed``, ``gpt.qkv``, ``gpt.attention``, ``gpt.out``, ``gpt.mlp``,
``moe.*``), in every phase, from the host-traced window, mean over ranks.
With ``optimizer_ew_ms``, ``loss_ew_ms``, ``norm_ew_ms`` and
``unattributed_ew_ms`` it partitions the window's elementwise time."""

from port_bench.regions import ms

OTHERS = ("train.optimizer", "gpt.head_loss", "gpt.ln", None)


def read(run):
    return ms(run, lambda region, phase, group: group == "other" and region not in OTHERS)
