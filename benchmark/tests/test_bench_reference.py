"""The plain reference against a dense numpy product at a tiny size."""

import numpy as np
import pytest
import torch

from harness import reference, spec


def _numpy_dense(name, pts, params):
    d = np.linalg.norm(pts[:, :, None] - pts[:, None, :], axis=0)
    if name == "inverse_distance":
        return 1.0 / (params["shift"] + d)
    phase = np.exp(1j * params["wavenumber"]
                   * (pts[0][:, None] - pts[0][None, :]))
    return phase / (params["shift"] + d)


@pytest.mark.parametrize("config", ["invdist-n40k-f32",
                                    "helmholtz-n100k-c64"])
def test_dense_product_matches_numpy(config):
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / f"{config}.json")
    geom = spec.load_module(
        spec.BENCH_DIR / "geometries" / f"{cfg['geometry']}.py", "g")
    kmod = spec.load_module(
        spec.BENCH_DIR / "kernels" / f"{cfg['kernel']['name']}.py", "k")
    rng = np.random.default_rng(3)
    pts = geom.points(300, rng)
    assert pts.shape == (3, 300)
    X = rng.standard_normal((300, 3))
    if kmod.IS_COMPLEX:
        X = X + 1j * rng.standard_normal((300, 3))
    want = _numpy_dense(cfg["kernel"]["name"], pts, cfg["kernel"]) @ X
    got = reference.dense_product(kmod.kernel(cfg["kernel"]), pts,
                                  torch.as_tensor(X), block=128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    K = reference.dense_matrix(kmod.kernel(cfg["kernel"]), pts, "cpu",
                               block=128)
    np.testing.assert_allclose(
        K.numpy(), _numpy_dense(cfg["kernel"]["name"], pts, cfg["kernel"]),
        rtol=1e-14)


@pytest.mark.parametrize("precision,bits", [("tf32", 10), ("bf16", 7),
                                            ("fp8", 3)])
def test_rounding_keeps_the_stated_mantissa(precision, bits):
    t = torch.linspace(-3.0, 3.0, 10001, dtype=torch.float64)
    r = reference.round_to(t, precision)
    normal = t.abs() > 0.05  # above fp8's subnormal range
    rel = ((r - t).abs() / t.abs())[normal].max().item()
    assert 2.0 ** -(bits + 2) < rel <= 2.0 ** -(bits + 1) * 1.0001
    z = reference.round_to(t + 1j * t, precision)
    assert torch.equal(z.real, r) and torch.equal(z.imag, r)
    assert torch.equal(reference.round_to(t, None), t)


def test_column_errors():
    R = torch.tensor([[1.0, 2.0], [1.0, 0.0], [1.0, -2.0], [1.0, 0.0]],
                     dtype=torch.float64)
    Y = R.clone()
    Y[0, 0] += 0.1
    rel, row = reference.column_errors(Y, R)
    assert rel[0] == pytest.approx(0.05) and rel[1] == 0.0
    assert row[0] == pytest.approx(0.1) and row[1] == 0.0
