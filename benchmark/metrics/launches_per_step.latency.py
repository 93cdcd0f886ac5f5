"""launches_per_step.latency: device operations (kernels, copies,
fills) the profiler traced, over the closed-loop steps traced."""


def read(run):
    t = run.trace
    if t is None or not t.steps or not t.device_ops:
        return None
    return sum(n for n, _ in t.device_ops.values()) / t.steps
