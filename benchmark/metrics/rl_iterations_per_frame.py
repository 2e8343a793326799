"""rl_iterations_per_frame: the program's `rl_iterations` counter over
the traced slice's requests, over its frames (one frame a request in the
stream cell): the configuration's rl_iters while RL's loop runs whole
(moves frame_ms_p50). None where the program keeps no such counter."""

from benchmark.program_spans import slice_snapshot


def read(run):
    snap = slice_snapshot(run)
    if snap is None or "rl_iterations" not in snap.counters or not run.traced.frames:
        return None
    return snap.counters["rl_iterations"] / run.traced.frames
