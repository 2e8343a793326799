"""rl_update_device_ms: device ms a request of the rows launched under
`fphase_rl_iteration` and outside its `fphase_rl_conv` ranges in the
traced slice: RL's elementwise update (the divide, the product, the
clamp), the target of fusing it into the convolutions' kernels (moves
frame_ms_p50). None where no row was (a program without the range)."""


def read(run):
    if run.report is None or run.traced is None or not run.traced.requests:
        return None
    seconds = run.report.phases_s.get("rl_iteration", 0.0)
    return seconds / run.traced.requests * 1e3 if seconds > 0 else None
