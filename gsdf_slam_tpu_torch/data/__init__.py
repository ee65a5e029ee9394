"""Dataset parsers and loaders (KITTI, Oxford-Spires, Replica, TUM, EuRoC):
copies of the JAX package's numpy `data/` modules, and a loader whose LiDAR
colourisation runs as a torch op on the card."""

from .base_parser import (  # noqa: F401
    CameraIntrinsics,
    FrameSet,
    align_by_timestamp,
    list_files,
    load_poses,
)
from .kitti import KittiParser  # noqa: F401
from .loader import DATASET_TYPES, DataLoader, FrameData, colorize_frame  # noqa: F401
from .pointcloud_io import read_kitti_bin, read_pcd, read_ply_points, read_points  # noqa: F401
from .replica import ReplicaParser, backproject_depth  # noqa: F401
from .spires import SpiresParser  # noqa: F401
from .tum import TumParser  # noqa: F401
