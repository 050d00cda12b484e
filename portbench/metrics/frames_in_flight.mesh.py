"""The mean over the window's requests of the host time of their
``mesh.frame`` spans, summed, over the host time of their ``batch`` root:
the frames in flight at once, on average (1: one after another; the mesh's
batch rows: every row busy all the time)."""

from portbench import program

program.record()


def read(run):
    trees = program.window(run)
    if not trees or any(t[0].name != "batch" or t[0].end_ns is None for t in trees):
        return None
    shares = []
    for tree in trees:
        frames = [s.ms for s in tree if s.name == "mesh.frame" and s.end_ns is not None]
        if not frames:
            return None
        shares.append(sum(frames) / tree[0].ms)
    return sum(shares) / len(shares)
