"""Ops of the port; the Chamfer loss and the nearest-neighbour distance are
exported here, as nope_nerf_tpu/ops/__init__.py exports them."""

from .chamfer import chamfer_loss, nearest_dists
