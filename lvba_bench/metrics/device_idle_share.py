"""device_idle_share: 1 − (the union of the device's operation
intervals under torch.profiler) / (the host clock's wall time of the same
solves run just before without the profiler).  The profiler slows the
host's CUDA graph launches (plane_w512.f32's solves take 1.7-1.9x as
long on an H100), so the traced window's own wall would read the
profiler's idle time as the program's."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["untraced_s"]:
        return None
    return 1.0 - tr["busy_s"] / tr["untraced_s"]
