"""The stem (``models/resnet.py::stem_forward``, kernel K10 on the card)
against the JAX package on the CPU in float32: the port's plain version,
which a CPU tensor takes, against JAX ``stem_forward`` on both of its
branches (space-to-depth when H and W divide by 4, the direct conv
otherwise), the extractor through the wrapper, and the wrapper's refusal of
gradients through K10 (the decision that runs on any device)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask_rcnn_tpu.models import resnet as jax_resnet
from mask_rcnn_tpu.utils import checkpoint as jax_ckpt
from mask_rcnn_tpu_torch.models import resnet
from mask_rcnn_tpu_torch.utils import checkpoint


def stem_params(seed=0):
    """The JAX package's stem params (he_normal conv1, bn1 scale 0.5) with a
    random bias, and the port's copy through the bridge."""
    rng = np.random.RandomState(seed)
    jparams = {
        "conv1": {"W": (rng.randn(7, 7, 3, 64) * 0.11).astype(np.float32)},
        "bn1": {"scale": (rng.rand(64) + 0.25).astype(np.float32),
                "bias": (rng.randn(64) * 0.5).astype(np.float32)},
    }
    flat = {f"extractor/{k}": v
            for k, v in jax_ckpt.flatten_params(jparams).items()}
    tparams = checkpoint.params_from_numpy(flat)["extractor"]
    return jparams, tparams


@pytest.mark.parametrize("shape", [
    (2, 64, 96, 3),   # JAX's space-to-depth branch
    (1, 62, 90, 3),   # JAX's direct branch (H, W not divisible by 4)
    (1, 61, 91, 3),   # odd sizes: the last pool window holds one conv row
    (1, 65, 68, 3),
])
def test_stem_matches_jax(shape):
    jparams, tparams = stem_params()
    x = np.random.RandomState(1).randn(*shape).astype(np.float32) * 50
    want = np.asarray(jax_resnet.stem_forward(jparams, jnp.asarray(x)))
    with torch.no_grad():
        got = resnet.stem_forward(tparams, torch.from_numpy(x)).numpy()
    n, h, w, _ = shape
    assert got.shape == want.shape == (n, -(-h // 4), -(-w // 4), 64)
    # float32 both sides; the JAX docstring gives ~1e-7 relative between
    # its branches, and oneDNN sums the 147 taps in another order: 1e-5 of
    # the largest value
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_extractor_through_the_stem_wrapper_matches_jax():
    """The port's seeded extractor, carried to the JAX layout through the
    parameter bridge (exact, tests/test_torch_models.py)."""
    tparams = resnet.init_extractor(torch.Generator().manual_seed(0))
    jparams = jax_ckpt.unflatten_params(checkpoint.params_to_numpy(tparams))
    x = np.random.RandomState(2).randn(1, 64, 96, 3).astype(np.float32) * 10
    want = np.asarray(jax_resnet.extractor_forward(jparams, jnp.asarray(x)))
    resnet.stem_forward.launches = 0
    with torch.no_grad():
        got = resnet.extractor_forward(tparams, torch.from_numpy(x)).numpy()
    assert resnet.stem_forward.launches == 0  # CPU: the plain version
    # tests/test_torch_models.py's backbone tolerance
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("grad_mode,needs", [
    (False, "x"), (True, None), (True, "x"), (True, "W"), (True, "scale"),
])
def test_stem_wants_grad(grad_mode, needs):
    """K10 has no backward: the wrapper refuses a CUDA call whenever
    autograd would want the stem's gradient, and only then."""
    _, tparams = stem_params()
    x = torch.zeros(1, 8, 8, 3)
    leaves = {"x": x, "W": tparams["conv1"]["W"],
              "scale": tparams["bn1"]["scale"]}
    if needs:
        leaves[needs].requires_grad_(True)
    with torch.set_grad_enabled(grad_mode):
        got = resnet.stem_wants_grad(tparams, x)
    assert got == (grad_mode and needs is not None)


def test_train_extractor_runs_the_stem_without_autograd(monkeypatch):
    """With the cut after res2 (the default ``freeze_at``) the stem runs
    under ``no_grad``, so the train path never asks K10 for a gradient even
    when conv1 requires one; without the cut the CPU plain version still
    gives conv1 its gradient."""
    params = resnet.init_extractor(torch.Generator().manual_seed(0))
    for t in checkpoint.flatten_params(params).values():
        t.requires_grad_(True)
    x = torch.randn(1, 32, 32, 3)
    seen = []
    real = resnet.stem_forward

    def spy(p, inp):
        seen.append(resnet.stem_wants_grad(p, inp))
        return real(p, inp)

    monkeypatch.setattr(resnet, "stem_forward", spy)
    resnet.extractor_forward(params, x, train=True, freeze_at="res2")
    resnet.extractor_forward(params, x, train=True, freeze_at=None).sum() \
        .backward()
    assert seen == [False, True]
    assert params["conv1"]["W"].grad is not None
