"""torch_op_ms: device ms a frame of everything else on the device (the
transport's PyTorch kernels, copies and fills), over the profiled frames."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.frames or not p.device:
        return None
    us = sum(t - s for e, s, t in p.clipped()
             if not (e.cat == "kernel" and ctx.is_hand_kernel(e.name)))
    return us * 1e-3 / p.frames
