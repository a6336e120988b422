"""Keypoint-free SfM (port of ``onepose_plus_plus_tpu/sfm``): covisible pairs,
batched LoFTR coarse matching, merged keypoints, epipolar verification and
triangulation with known poses, fine refinement and the depth solve, point
filtering and the 3D annotations. ``runner.run_sfm`` drives one object;
``python -m onepose_plus_plus_tpu_torch.sfm`` (``cli.py``) every object of a
dataset. The incremental SfM of the JAX package (``incremental.py``, with
``lm_solve`` and ``bundle_adjust.py``) is not ported yet: ``run_sfm`` does not
call it."""
