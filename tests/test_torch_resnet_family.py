"""PyTorch port, Res2Net, the SK nets and SENet against the JAX package on
CPU: eval logits at 64² and 72² within 1e-4 of the logit scale and the
bridge's round trip exact, by ``test_torch_resnet_models.py``'s method.
72² gives SENet's ceil-mode stem pool an even map (36 → 18, not 17).

Every path, SENet154's (the ``se`` block: 1×1 to 2×planes, grouped 3×3 to
4×planes, the 3×3×3 stem, 3×3 shortcuts) among them, is held at two
blocks a stage, as that file explains.
"""

import pytest

from test_torch_resnet_models import (by_name, check_eval_logits,
                                      check_round_trip, jax_calibrated)

PATHS = ["res2net50_26w_4s", "skresnet18", "skresnext50_32x4d",
         "seresnet18", "senet154"]


@pytest.mark.parametrize("name", PATHS)
def test_eval_logits_match_jax(name):
    check_eval_logits(jax_calibrated(**by_name(name, drop_rate=0.0)), name)


@pytest.mark.parametrize("name", PATHS)
def test_bridge_round_trip_is_exact(name):
    check_round_trip(jax_calibrated(**by_name(name, drop_rate=0.0)), name)
