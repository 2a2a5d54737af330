"""The model under the sharding rules computes the function it computes
unsharded, for the families ``test_torch_sharded_step.py`` leaves out:
MLA (DeepSeek-V3's latent cache split along its sequence, its decode
softmax per shard), the encoder-decoder (Whisper's cross cache split
along its sequence in decode), the hybrid (Zamba2's shared attention
block beside the SSD) and the vlm (Qwen2-VL's M-RoPE on DTensors), each
a reduced float32 config in a spawned 4-rank gloo world on a 2x2 mesh:
the train step's loss and grad norm, the prefill's logits and a decode
step's within 1e-5 of the plain run's."""
import pytest

from test_torch_sharded_step import (check_decode, check_step_and_prefill,
                                     run_cases)

CASES = {"mla_moe": ("deepseek-v3-671b", None, None),
         "encdec": ("whisper-tiny", None, None),
         "hybrid": ("zamba2-2.7b", None, None),
         "vlm": ("qwen2-vl-7b", None, None)}


@pytest.fixture(scope="module")
def world():
    return run_cases(CASES)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_and_prefill_match_unsharded(world, case):
    check_step_and_prefill(world[case])


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_decode_step_matches_unsharded(world, case):
    check_decode(world[case])
