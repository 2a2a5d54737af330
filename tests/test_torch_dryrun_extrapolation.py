"""The dry run's extrapolation: the counts fitted from the 1- and
2-layer variants of each layer stack (``extrapolated_costs``, the
reference's method) against a full-depth fake run of the same config."""
import pytest

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch import dryrun as DR


@pytest.mark.parametrize("arch,shape", [
    ("qwen2.5-14b", ShapeConfig("train_4k", 64, 32, "train")),
    ("deepseek-v3-671b", ShapeConfig("train_4k", 64, 32, "train")),
    ("zamba2-2.7b", ShapeConfig("prefill_32k", 64, 32, "prefill")),
    ("whisper-tiny", ShapeConfig("decode_32k", 64, 32, "decode"))])
def test_extrapolation_equals_a_full_depth_run(arch, shape):
    """At a 4-layer reduced config (DeepSeek-V3 2 dense + 2 MoE, Zamba2
    4 SSM layers in 2 groups, Whisper 4 + 4) the counts fitted from the
    variants (``extrapolated_costs``) equal a full-depth fake run's within
    1e-6 relative: FLOPs, HBM bytes and each kind of collective bytes."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh
    cfg = get_config(arch).reduced().replace(num_layers=4)
    if cfg.family == "mla_moe":
        cfg = cfg.replace(first_dense_layers=2)
    if cfg.family == "hybrid":
        cfg = cfg.replace(attn_every=2)
    if cfg.family == "encdec":
        cfg = cfg.replace(encoder_layers=4)
    mesh = make_production_mesh()
    try:
        fit = DR.extrapolated_costs(cfg, shape, mesh)
        full = DR._measure(cfg, shape, mesh)
    finally:
        dist.destroy_process_group()
    keys = [k for k in full if k in ("flops", "hbm_bytes")
            or k.startswith("coll/")]
    assert "coll/total" in keys and full["flops"] > 0
    for k in keys:
        assert fit[k] == pytest.approx(full[k], rel=1e-6, abs=0), k
