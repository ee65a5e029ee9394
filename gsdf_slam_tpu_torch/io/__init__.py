"""Host IO: PLY checkpoints."""

from .ply import gaussians_to_ply_dict, ply_dict_to_gaussians, read_ply, write_ply, write_sparse_points_ply

__all__ = ["gaussians_to_ply_dict", "ply_dict_to_gaussians", "read_ply", "write_ply", "write_sparse_points_ply"]
