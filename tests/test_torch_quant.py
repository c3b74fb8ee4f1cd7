"""The port's int8 w8a8 path (``ops/quant.py``) against the JAX package's
on the CPU: ``quantize_rows``, ``int8_matmul`` and a tiny int8 DiT with the
same weights; ``QuantizableDense`` against ``Dense``; ``pred_rollout
--int8_matmuls`` end to end (here from a tar directory); and the trainer's
refusal of an int8 config.

Tolerances: the int8 values are integers and their products exact, so
``quantize_rows`` and ``int8_matmul`` agree with JAX bit for bit (q: no
element of 307,200 differs, not even at a tie; the product: relative 1e-6
allowed, 0 read). The tiny DiT's int8 forward agrees to 1e-5 relative L2
(2.1e-7 read), where int8 and float forwards differ by 2.9e-3: a site
quantised in one package and not in the other fails it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladcast_torch import config as t_config
from ladcast_torch.cli import pred_rollout as t_pred
from ladcast_torch.cli import train_ar as t_train_cli
from ladcast_torch.data import era5_tar as t_tar
from ladcast_torch.models import hub as t_hub
from ladcast_torch.models.dcae import build_dcae
from ladcast_torch.models.ladcast_dit import build_dit
from ladcast_torch.models.layers import Dense
from ladcast_torch.ops import quant as t_quant
from ladcast_tpu import config as j_config
from ladcast_tpu.models.ladcast_dit import LaDCastTransformer3D as JaxDiT
from ladcast_tpu.ops import quant as j_quant
from tests.test_torch_dit import TINY, _inputs, _torch_model
from tests.test_torch_forecast import DCAE_KW, DIT_KW, TINY_AR_CFG


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The test suite runs files in parallel workers on a shared CPU; two
    intra-op threads per worker keep them from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _gaussian(seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(4, 300, 256).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row: scale 1
    x[1, 1, :4] = [127.0, 0.5, -0.5, 1.5]  # ties at amax / 127 = 1
    x[1, 1, 4:] = 0.0
    k = (rng.randn(256, 512) / 16).astype(np.float32)
    b = rng.randn(512).astype(np.float32)
    return x, k, b


def test_quantize_rows_matches_jax():
    x, _, _ = _gaussian()
    q, s = t_quant.quantize_rows(torch.from_numpy(x))
    jq, js = j_quant.quantize_rows(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == (4, 300, 1)
    assert int((q.numpy() != np.asarray(jq)).sum()) == 0
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[0, 0, 0] == 1.0 and not q[0, 0].any()
    assert q[1, 1, :4].tolist() == [127, 0, 0, 2]  # half to even


def test_int8_matmul_matches_jax():
    x, k, b = _gaussian()
    w = torch.from_numpy(np.ascontiguousarray(k.T))  # (N, K), torch's layout
    for bias in (b, None):
        got = t_quant.int8_matmul(torch.from_numpy(x), w,
                                  None if bias is None else torch.from_numpy(bias))
        want = np.asarray(j_quant.int8_matmul(
            jnp.asarray(x), jnp.asarray(k), None if bias is None else jnp.asarray(bias)))
        assert got.dtype == torch.float32 and tuple(got.shape) == (4, 300, 512)
        assert _rel(got.numpy(), want) <= 1e-6
    # the int32 product is exact
    xq, _ = t_quant.quantize_rows(torch.from_numpy(x).reshape(-1, 256))
    wq, _ = t_quant.quantize_rows(w)
    acc = t_quant.int8_mm(xq, wq.t())
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(
        acc.numpy(), xq.numpy().astype(np.int64) @ wq.numpy().T.astype(np.int64))
    # bf16 in, bf16 out (the promoted dtype); float32 weight promotes
    xb = torch.from_numpy(x[:1]).bfloat16()
    assert t_quant.int8_matmul(xb, w.bfloat16()).dtype == torch.bfloat16
    assert t_quant.int8_matmul(xb, w).dtype == torch.float32
    with pytest.raises(ValueError, match="int8"):
        t_quant.int8_mm(xq.float(), wq.t())


def test_quantizable_dense_without_quant_is_dense():
    torch.manual_seed(0)
    ref = Dense(24, 40)
    layer = t_quant.QuantizableDense(24, 40)
    assert set(layer.state_dict()) == set(ref.state_dict())
    layer.load_state_dict(ref.state_dict(), strict=True)
    x = torch.randn(3, 17, 24)
    for xx in (x, x.bfloat16()):
        assert torch.equal(layer(xx), ref(xx))
    layer.quant = True
    assert set(layer.state_dict()) == set(ref.state_dict())
    with torch.no_grad():
        got = layer(x)
    assert torch.equal(got, t_quant.int8_matmul(x, ref.weight, ref.bias))
    assert _rel(got.numpy(), ref(x).detach().numpy()) < 2e-2


def test_quantizable_dense_quantizes_once_per_weight_version():
    torch.manual_seed(1)
    layer = t_quant.QuantizableDense(16, 8, quant=True)
    x = torch.randn(5, 16)
    with torch.no_grad():
        a = layer(x)
        kept = layer._qweight[1]
        assert torch.equal(layer(x), a) and layer._qweight[1] is kept
        layer.weight.mul_(2.0)  # an in-place change: a new version
        b = layer(x)
    assert layer._qweight[1] is not kept
    torch.testing.assert_close(b - layer.bias, 2 * (a - layer.bias))
    with torch.inference_mode():  # inference tensors carry no version
        c = layer(torch.randn(5, 16))
    assert c.shape == (5, 8)


QTINY = {**TINY, "attention_head_dim": 16, "rope_axes_dim": (4, 6, 6),
         "conditioning_tensor_rope_axes_dim": (4, 6, 6)}


def test_tiny_int8_dit_matches_jax():
    inputs = _inputs()
    jm = JaxDiT(j_config.LaDCastDiTConfig(**QTINY, attention_impl="xla"))
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), *map(jnp.asarray, inputs)))
    j8 = JaxDiT(j_config.LaDCastDiTConfig(**QTINY, attention_impl="xla",
                                          int8_matmuls=True))
    want8 = np.asarray(jax.jit(j8.apply)(params, *map(jnp.asarray, inputs)))
    want = np.asarray(jax.jit(jm.apply)(params, *map(jnp.asarray, inputs)))
    t8 = _torch_model({**QTINY, "int8_matmuls": True}, params)
    # exactly the JAX package's sites are quantised
    quantised = sorted(n for n, m in t8.named_modules()
                       if isinstance(m, t_quant.QuantizableDense) and m.quant)
    assert len(quantised) == 12 + 5
    assert all(n.startswith(("transformer_blocks.", "single_transformer_blocks."))
               and ".norm" not in n for n in quantised)
    with torch.no_grad():
        got8 = t8(*map(torch.from_numpy, inputs)).numpy()
    assert _rel(got8, want8) <= 1e-5, _rel(got8, want8)
    assert _rel(want8, want) > 1e-3  # the int8 forward is another function


def _raw_member_source(fields, stamps):
    """(lat, lon, C) fields as raw archive frames: a pole row in front and a
    surface-pressure channel behind, which the reader crops and drops."""

    class Src:
        def frames_at(self, ts):
            f = fields[[stamps.index(int(t)) for t in ts]]
            f = np.concatenate([f[:, :1], f], axis=1)
            return np.concatenate([f, np.full(f.shape[:-1] + (1,), 1e5, np.float32)],
                                  axis=-1)

    return Src()


def test_cli_pred_rollout_int8_end_to_end(tmp_path, monkeypatch):
    dit_dir, dcae_dir = str(tmp_path / "dit"), str(tmp_path / "dcae")
    dcfg, acfg = t_config.LaDCastDiTConfig(**DIT_KW), t_config.DCAEConfig(**DCAE_KW)
    t_hub.save_pretrained(dit_dir, "dit", dcfg,
                          build_dit(dcfg, "cpu", seed=3).state_dict())
    t_hub.save_pretrained(dcae_dir, "dcae", acfg,
                          build_dcae(acfg, "cpu", seed=4).state_dict())
    from ladcast_torch import static_data

    fm, fs = static_data.era5_mean_std()
    fields = (np.random.RandomState(5).randn(1, 120, 240, 84) * fs + fm
              ).astype(np.float32)
    fields[:, :30, :30, 82] = np.nan
    npz, tars = str(tmp_path / "era5.npz"), str(tmp_path / "tars")
    np.savez(npz, fields=fields, timestamps=np.asarray([2018010100], np.int64))
    t_tar.write_tar_archive(_raw_member_source(fields, [2018010100]), [2018010100], tars)

    calls = []
    real = t_quant.int8_mm
    monkeypatch.setattr(t_quant, "int8_mm", lambda a, b: calls.append(1) or real(a, b))
    runs = {}
    for name, data, extra in (("int8", tars, ["--int8_matmuls"]), ("float", npz, [])):
        out = str(tmp_path / name)
        args = t_pred.build_parser().parse_args([
            "--data", data, "--dit_params", dit_dir, "--dcae_params", dcae_dir,
            "--output_dir", out, "--start_date", "2018-01-01",
            "--end_date", "2018-01-01T12", "--num_samples_per_month", "1",
            "--ensemble_size", "2", "--num_inference_steps", "2",
            "--return_seq_len", "2", "--total_lead_time_hour", "12",
            "--device", "cpu", *extra])
        n0 = len(calls)
        recs = t_pred.run(args, compute_dtype="float32")
        runs[name] = (np.load(os.path.join(out, "latent_2018010100.npy")),
                      len(calls) - n0)
        # 12z is not in the archive or the bundle: skipped, not fatal
        assert [r["init_time"] for r in recs if "skipped" in r] == [2018010112]
    (a8, n8), (af, nf) = runs["int8"], runs["float"]
    # per DiT call, 12 quantised projections per dual-stream block and 5
    # per single-stream block; Heun-2 makes 3 calls per repetition
    assert (n8, nf) == (3 * (12 + 5), 0)
    assert a8.shape == af.shape == (2, 84, 3, 15, 30) and np.isfinite(a8).all()
    np.testing.assert_array_equal(a8[:, :, 0], af[:, :, 0])  # the same encoded t=0
    assert 0 < _rel(a8[:, :, 1:], af[:, :, 1:]) < 5e-2


def test_train_ar_refuses_an_int8_config(tmp_path):
    cfg = {**TINY_AR_CFG, "ar_model": {**TINY_AR_CFG["ar_model"], "int8_matmuls": True}}
    args = t_train_cli.build_parser().parse_args(
        ["--latents", str(tmp_path / "none.npz"), "--device", "cpu",
         "--output_dir", str(tmp_path / "x")])
    with pytest.raises(SystemExit, match="inference-only"):
        t_train_cli.run(cfg, args)
