"""host_syncs: synchronizing calls a solve under sync debug mode "warn"
(route set-up, the convergence reads and the read-back of the poses)."""


def read(rec):
    return rec["probes"].get("host_syncs")
