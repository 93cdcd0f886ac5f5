"""Trajectory IO in the reference's formats, and section timing."""

from hectr_tpu_torch.utils.pmu import Timer, timed
from hectr_tpu_torch.utils.trajio import (
    read_traj_bin,
    traj_compare,
    write_traj_bin,
    write_traj_txt,
)

__all__ = ["write_traj_txt", "write_traj_bin", "read_traj_bin", "traj_compare",
           "Timer", "timed"]
