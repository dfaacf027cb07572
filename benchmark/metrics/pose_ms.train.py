"""Device milliseconds a train sub-step of the pose path: the stages `pose`
(the camera-frame rays posed from the learned-pose table) and
`pose_backward` (its backward, `d_inp` into the table), by the program's
stage marks (benchmark/stages.py)."""
from benchmark import stages


def read(w, cell):
    segs = stages.sub_steps(w, cell)
    if segs is None or not any("pose" in s for s in segs):
        return None
    return stages.ms(segs, ("pose", "pose_backward"), len(segs))
