"""restore_roofline.rl: the RL restore's least time over device busy in
the traced slice, % (roofline/rl_counts.py; moves frame_ms_p50)."""

from benchmark.roofline import rl_counts


def read(run):
    return rl_counts.slice_share(run)
