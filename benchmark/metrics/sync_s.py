"""sync_s: the harness's span around HostScene.sync (BVH builds, tables,
texture pool, upload; the cluster tiles under intersector "cluster")."""


def read(rec):
    return rec["spans"].get("sync_s")
