"""The production programs lower for CUDA from this CPU host.

``jax.export`` with ``platforms=("cuda",)`` runs the whole GPU lowering —
every op the card will see — with no card present, so a program the GPU
backend cannot express (or one that needs a custom call without a
stability guarantee) fails here rather than on the first chip run. Production shapes: BN254 at 2^20
(chunk 16) and BLS12-381 at 2^16 (chunk 13), one-shot and plan call."""

import jax
import jax.numpy as jnp
import pytest
from jax import export

from msm_tpu.models import cuzk, plan
from msm_tpu.models.geometry import pick_geometry
from msm_tpu.ops.packing import coord_words
from msm_tpu.params import BLS12_381, BN254, pick_config


@pytest.mark.parametrize("mode", ["one_shot", "plan"])
@pytest.mark.parametrize(
    "curve,log_n", [(BN254, 20), (BLS12_381, 16)], ids=["bn254", "bls12_381"]
)
def test_production_pipeline_lowers_for_cuda(curve, log_n, mode):
    n = 1 << log_n
    cfg = pick_config(n, curve)
    geom = pick_geometry(n, cfg.chunk_size)
    cw = (curve.modulus_bits + 7) // 8 // 2  # u16 words per coordinate
    sw = cfg.scalar_bits // 16
    i32 = jnp.int32
    if mode == "one_shot":
        fn = jax.jit(lambda x, y, s: cuzk.cuzk_msm_point(x, y, s, cfg, geom))
        args = (
            jax.ShapeDtypeStruct((n, cw), i32),
            jax.ShapeDtypeStruct((n, cw), i32),
            jax.ShapeDtypeStruct((n, sw), i32),
        )
    else:
        fn = jax.jit(lambda t, s: plan._plan_msm_point(t, s, cfg, geom))
        args = (
            jax.ShapeDtypeStruct((1, n, 2 * coord_words(cfg)), i32),
            jax.ShapeDtypeStruct((n, sw // 2), i32),
        )
    exp = export.export(fn, platforms=("cuda",))(*args)
    assert exp.platforms == ("cuda",)
    assert exp.out_avals[0].shape == (3, cfg.num_words)
    text = exp.mlir_module()
    assert "tpu" not in text.lower().replace("msm_tpu", "")
