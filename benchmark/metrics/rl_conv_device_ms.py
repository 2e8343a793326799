"""rl_conv_device_ms: device ms a request of the rows launched under
`fphase_rl_conv` in the traced slice: RL's convolutions (B1, B2 'conv'
and its conj, B6, and the scale), the innermost range around their
launches (moves frame_ms_p50). None where no row was (a program without
the range)."""


def read(run):
    if run.report is None or run.traced is None or not run.traced.requests:
        return None
    seconds = run.report.phases_s.get("rl_conv", 0.0)
    return seconds / run.traced.requests * 1e3 if seconds > 0 else None
