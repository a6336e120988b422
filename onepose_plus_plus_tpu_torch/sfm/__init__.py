"""Keypoint-free SfM (port of ``onepose_plus_plus_tpu/sfm``): covisible pairs,
batched LoFTR coarse matching, merged keypoints, epipolar verification and
triangulation with known poses, fine refinement and the depth solve, point
filtering and the 3D annotations. ``runner.run_sfm`` drives one object;
``python -m onepose_plus_plus_tpu_torch.sfm`` (``cli.py``) every object of a
dataset. ``incremental.incremental_sfm`` maps a scene whose poses are unknown
(with ``geometry/bundle_adjust.py`` and the D-parameter ``lm_solve``);
``run_sfm`` does not call it."""
