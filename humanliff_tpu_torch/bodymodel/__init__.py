"""SMPL/SMPL-X body models and the canonical-space (inverse-LBS) deform (port of
``humanliff_tpu/bodymodel``)."""
