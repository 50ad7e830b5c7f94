"""map_build_s: the host clock around build_voxel_map and
buckets_to_device, ending in a synchronize (s)."""


def read(rec):
    return rec["spans"].get("map_build_s")
