"""The port's metrics (``free_hunch_tpu_torch/metrics``) against the JAX
package's ``free_hunch_tpu/metrics`` on the same inputs and weights:

* PSNR and SSIM on seeded uint8 batches, per image: 1e-5 relative (f32
  sums in another order);
* the LPIPS proxy: 1e-5 relative;
* native LPIPS from one seeded VGG16 + heads npz, loaded by both packages,
  at 32 and 64 px: 1e-5 relative to the largest distance (observed ~1e-7);
* InceptionV3 pool3 features from ``random_params(3)`` with randomised BN
  statistics, at 96 px unresized and at 32 px resized to 299: 1e-4 of the
  largest |feature|;
* ``FeatureStats``, ``frechet_distance`` and ``compute_fid`` on numpy data
  (float64, the same code: 1e-12);
* weights paths that do not exist or lack keys, and reference statistics of
  the other feature network, raise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from free_hunch_tpu.metrics import fid as JF
from free_hunch_tpu.metrics import lpips_jax as JL
from free_hunch_tpu.metrics import quality as JQ
from free_hunch_tpu_torch.metrics import fid as TF
from free_hunch_tpu_torch.metrics import lpips as TL
from free_hunch_tpu_torch.metrics import quality as TQ
from tests._torch_parity import one_thread  # noqa: F401

VGG = [(0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128), (10, 128, 256),
       (12, 256, 256), (14, 256, 256), (17, 256, 512), (19, 512, 512), (21, 512, 512),
       (24, 512, 512), (26, 512, 512), (28, 512, 512)]


def lpips_npz(path, seed=0):
    """A seeded VGG16 features + LPIPS heads npz in the format both
    packages load (``convert_torch_weights``)."""
    rng = np.random.default_rng(seed)
    vgg, lins = {}, {}
    for idx, cin, cout in VGG:
        vgg[f"{idx}.weight"] = rng.normal(0, np.sqrt(2.0 / (cin * 9)),
                                          (cout, cin, 3, 3)).astype(np.float32)
        vgg[f"{idx}.bias"] = rng.normal(0, 0.01, cout).astype(np.float32)
    for i, c in enumerate(TL.TAP_CHANNELS):
        lins[f"lins.{i}.model.1.weight"] = rng.uniform(0, 1, (1, c, 1, 1)).astype(np.float32)
    params = TL.convert_torch_weights(vgg, lins)
    want = JL.convert_torch_weights(vgg, lins)
    assert all(np.array_equal(params[k], want[k]) for k in want)
    np.savez(path, **params)
    return str(path)


def _u8(seed, shape=(3, 3, 40, 36)):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape).astype(np.uint8)
    noise = rng.integers(-40, 41, shape)
    return a, np.clip(a.astype(np.int64) + noise, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1])
def test_psnr_and_ssim_equal_jax(seed):
    a, b = _u8(seed)
    tp = TQ.psnr(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    jp = np.asarray(JQ.psnr(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)))
    np.testing.assert_allclose(tp, jp, rtol=1e-5)
    ts = TQ.ssim(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    js = np.asarray(jax.vmap(lambda u, v: JQ.ssim(u, v, channel_axis=0))(
        jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)))
    assert ts.shape == (3,)
    np.testing.assert_allclose(ts, js, rtol=1e-5)
    # one image without a batch axis gives a scalar
    assert TQ.ssim(torch.as_tensor(a[0]), torch.as_tensor(b[0])).shape == ()


def test_identical_images_read_perfect():
    a, _ = _u8(2)
    assert float(TQ.ssim(torch.as_tensor(a), torch.as_tensor(a)).min()) == pytest.approx(1.0)
    assert float(TQ.psnr(torch.as_tensor(a), torch.as_tensor(a)).min()) > 100


def test_perceptual_proxy_equals_jax():
    a, b = _u8(3, (2, 3, 32, 32))
    fa, fb = a.astype(np.float32) / 127.5 - 1, b.astype(np.float32) / 127.5 - 1
    got = float(TQ._perceptual_proxy(torch.as_tensor(fa), torch.as_tensor(fb)))
    want = float(JQ._perceptual_proxy(jnp.asarray(fa), jnp.asarray(fb)))
    assert got == pytest.approx(want, rel=1e-5)
    fn = TQ.lpips_fn("vgg", device="cpu")
    assert fn.is_proxy is True and fn(fa, fb) == pytest.approx(got, rel=1e-6)


@pytest.mark.parametrize("res", [32, 64])
def test_native_lpips_equals_jax(tmp_path, res):
    path = lpips_npz(tmp_path / "lpips.npz")
    rng = np.random.default_rng(res)
    a = rng.uniform(-1, 1, (2, 3, res, res)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), -1, 1).astype(np.float32)
    jparams = {k: jnp.asarray(v) for k, v in JL.load_weights(path).items()}
    want = np.asarray(JL.lpips_forward(jparams, jnp.asarray(a), jnp.asarray(b)))
    model = TL.make_lpips(path, device="cpu")
    with torch.no_grad():
        got = model(torch.as_tensor(a), torch.as_tensor(b)).numpy()
        same = TL.lpips_forward(TL.load_weights(path), torch.as_tensor(a),
                                torch.as_tensor(a)).numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(same, 0.0, atol=1e-7)
    fn = TQ.lpips_fn("vgg", weights_path=path, device="cpu")
    assert fn.is_proxy is False
    assert fn(a, b) == pytest.approx(float(want.mean()), rel=1e-5)


def test_lpips_weights_fail_fast(tmp_path):
    with pytest.raises(FileNotFoundError, match="LPIPS weights"):
        TQ.lpips_fn("vgg", weights_path=str(tmp_path / "nope.npz"), device="cpu")
    partial = tmp_path / "partial.npz"
    np.savez(partial, conv0_w=np.zeros((64, 3, 3, 3), np.float32))
    with pytest.raises(KeyError, match="incomplete"):
        TL.load_weights(str(partial))
    with pytest.raises(ValueError, match="lin head"):
        vgg = {f"{i}.{k}": np.zeros(1) for i, _, _ in VGG for k in ("weight", "bias")}
        TL.convert_torch_weights(vgg, {f"lin{i}": np.zeros(7) for i in range(5)})


def _raw_with_bn_stats():
    rng = np.random.default_rng(7)
    raw = TF.random_params(seed=3)
    jraw = JF.random_params(seed=3)
    assert all(np.array_equal(raw[k], jraw[k]) for k in jraw) and raw.keys() == jraw.keys()
    for name, _, cout, _, _, _ in TF.all_conv_specs():
        raw[f"{name}.bn.weight"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
        raw[f"{name}.bn.bias"] = rng.normal(0, 0.1, cout).astype(np.float32)
        raw[f"{name}.bn.running_mean"] = rng.normal(0, 0.1, cout).astype(np.float32)
        raw[f"{name}.bn.running_var"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    return raw


@pytest.mark.parametrize("res,resize", [(96, False), (32, True)])
def test_inception_features_equal_jax(res, resize):
    raw = _raw_with_bn_stats()
    folded = TF._fold_bn(raw)
    jfolded = JF._fold_bn(raw)
    assert all(np.array_equal(folded[k], jfolded[k]) for k in jfolded)
    x = np.random.default_rng(res).uniform(-1, 1, (2, 3, res, res)).astype(np.float32)
    want = np.asarray(JF.inception_features({k: jnp.asarray(v) for k, v in jfolded.items()},
                                            jnp.asarray(x), resize=resize))
    net = TF.InceptionFeatures(folded).eval()
    with torch.no_grad():
        got = net(torch.as_tensor(x), resize=resize).numpy()
    assert got.shape == want.shape == (2, TF.FEATURE_DIM)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_weights_file_round_trip(tmp_path):
    raw = _raw_with_bn_stats()
    state = {}
    for name, _, _, _, _, _ in TF.all_conv_specs():
        state[f"{name}.conv.weight"] = raw[f"{name}.w"]
        for k in ("weight", "bias", "running_mean", "running_var"):
            state[f"{name}.bn.{k}"] = raw[f"{name}.bn.{k}"]
    path = str(tmp_path / "inception.npz")
    np.savez(path, **TF.convert_torch_weights(state))
    got, want = TF.load_weights(path), JF.load_weights(path)
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
    _, is_proxy = TF.make_extractor(path, device="cpu")
    assert is_proxy is False


def test_fid_weights_fail_fast(tmp_path):
    with pytest.raises(FileNotFoundError, match="FID weights"):
        TF.load_weights(str(tmp_path / "nope.npz"))
    with pytest.raises(FileNotFoundError, match="FID weights"):
        TF.make_extractor(str(tmp_path / "nope.npz"), device="cpu")
    partial = str(tmp_path / "partial.npz")
    np.savez(partial, **{"Conv2d_1a_3x3.w": np.zeros((32, 3, 3, 3), np.float32)})
    with pytest.raises(KeyError, match="incomplete"):
        TF.load_weights(partial)
    assert TF.load_weights(None) is None


def test_feature_stats_and_frechet_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=(50, 8)), rng.normal(0.3, 1.2, size=(40, 8))
    t, j = TF.FeatureStats(8), JF.FeatureStats(8)
    for i in range(0, 50, 7):  # ragged chunks
        t.add(x[i:i + 7])
        j.add(x[i:i + 7])
    for a, b in zip(t.mu_sigma(), j.mu_sigma()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(t.mu_sigma()[1], np.cov(x, rowvar=False), atol=1e-12)
    # two shards merged equal the whole
    a, b = TF.FeatureStats(8), TF.FeatureStats(8)
    a.add(torch.as_tensor(x[:20]))
    b.add(x[20:])
    a.merge_arrays(b.n, b.s, b.ss)
    for u, v in zip(a.mu_sigma(), t.mu_sigma()):
        np.testing.assert_allclose(u, v, atol=1e-12)
    ref = str(tmp_path / "ref.npz")
    ry = TF.FeatureStats(8)
    ry.add(y)
    ry.save(ref, is_proxy=True)
    got, want = TF.compute_fid(t, ref), JF.compute_fid(j, ref)
    assert got == pytest.approx(want, rel=1e-12) and got > 0
    mu, sig = t.mu_sigma()
    assert TF.frechet_distance(mu, sig, mu, sig) == pytest.approx(0.0, abs=1e-8)
    # a singular product takes the jitter retry, as in the JAX package
    r = rng.normal(size=(3, 8))
    s1 = np.cov(r, rowvar=False)
    assert TF.frechet_distance(mu, s1, mu, s1) == pytest.approx(
        JF.frechet_distance(mu, s1, mu, s1), rel=1e-9, abs=1e-9)
    with pytest.raises(ValueError):
        TF.FeatureStats(8).mu_sigma()


def test_install_fid_rejects_proxy_mismatch(tmp_path):
    from free_hunch_tpu_torch.eval import Evaluator

    extract, is_proxy = TF.make_extractor(device="cpu")
    assert is_proxy
    st = TF.FeatureStats()
    st.add(extract(torch.zeros((2, 3, 32, 32))))
    ref = str(tmp_path / "real_stats.npz")
    st.save(ref, is_proxy=False)  # claims real-weight features
    ev = Evaluator.__new__(Evaluator)  # _install_fid reads opts, fid_weights, device
    ev.opts, ev.fid_weights, ev.device = dict(fid_ref_stats=ref), None, torch.device("cpu")
    with pytest.raises(ValueError, match="proxy"):
        ev._install_fid()
    st.save(ref, is_proxy=True)
    ev._install_fid()
    assert ev._fid is not None and ev._fid["is_proxy"] is True
    ev.opts = dict(fid_ref_stats=str(tmp_path / "missing.npz"))
    with pytest.raises(FileNotFoundError, match="fid_ref_stats"):
        ev._install_fid()
