"""The port's measurement layer: phase timers on the host clock
(timing.py) and device time read from a torch.profiler trace
(trace_profile.py). Counterpart of fft_restoration_tpu/utils/timing.py
and utils/trace_profile.py; imports torch, never JAX."""
