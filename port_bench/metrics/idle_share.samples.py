"""idle_share.samples (%), layer device: the share of the traced window in
which no kernel, copy or set runs on the card (the union of
torch.profiler's CUDA activity)."""


def read(ctx):
    t = ctx["trace"]
    return None if t is None else t.idle_share()
