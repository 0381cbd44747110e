"""The README's demo scripts, as modules of the port (counterparts of the
repository's scripts/*.py): `python -m nope_nerf_torch.scripts.<name>`.

- make_demo_scene: the 20-frame V-KITTI-layout driving scene on disk;
- make_nonmetric_priors: affine-corrupted depth priors as DPT npz files;
- demo_joint_pose_training: joint NeRF and pose training from identity poses.
"""
