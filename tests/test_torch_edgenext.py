"""The port's EdgeNeXt slice against the JAX package, on the CPU.

Weights come from ``repro.models.params.init_params`` (or are random
numpy arrays of the same tree), are turned to numpy and carried across by
``from_jax_params``; images are numpy arrays from a seed.  Tolerance 2e-4
on logits and block outputs: float32 sums taken in another order by the
two frameworks, through up to five blocks.
"""
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import edgenext_s as jcfg
from repro.models import edgenext as JE
from repro.models import params as JP
from repro_torch.configs import edgenext_s as tcfg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import edgenext as TE
from repro_torch.models import params as TP
from repro_torch.serve_edgenext import serve

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _random_tree(tree, seed, scale=0.1):
    """Every leaf moved by seeded noise: biases, layer scales and
    temperatures that the initialiser leaves at 0 or 1 take part."""
    r = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * r.standard_normal(a.shape)
                   ).astype(np.float32), tree)


def _jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t_tree(tree):
    return TP.from_jax_params(tree, device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def reduced():
    cfg = jcfg.reduced_edgenext()
    init = _np_tree(JP.init_params(jax.random.PRNGKey(0), JE.param_defs(cfg)))
    images = np.random.default_rng(0).standard_normal(
        (2, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    return dict(cfg=cfg, tcfg=tcfg.reduced_edgenext(), init=init,
                rand=_random_tree(init, 1), images=images)


# ---------------------------------------------------------------------------
# configuration and parameter tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["CONFIG", "reduced"])
def test_config_is_a_faithful_copy(which):
    a = jcfg.CONFIG if which == "CONFIG" else jcfg.reduced_edgenext()
    b = tcfg.CONFIG if which == "CONFIG" else tcfg.reduced_edgenext()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("which", ["CONFIG", "reduced"])
def test_param_defs_match_jax(which):
    a = JE.param_defs(jcfg.CONFIG if which == "CONFIG"
                      else jcfg.reduced_edgenext())
    b = TE.param_defs(tcfg.CONFIG if which == "CONFIG"
                      else tcfg.reduced_edgenext())
    flat_a = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(
                  a, is_leaf=lambda x: isinstance(x, JP.ParamDef))[0]}
    flat_b = {}
    TP.tree_map(lambda d, path: flat_b.__setitem__(path, d), b)
    norm = lambda k: re.sub(r"\['?([^'\]]+)'?\]", r".\1", k).lstrip(".")  # noqa: E731
    assert {norm(k) for k in flat_a} == set(flat_b)
    for k, d in flat_a.items():
        e = flat_b[norm(k)]
        assert (tuple(d.shape), d.init, d.scale) == (tuple(e.shape), e.init,
                                                     e.scale), k
    assert TP.count_params(b) == JP.count_params(a)


def test_init_params_is_seeded_and_follows_the_definitions(reduced):
    defs = TE.param_defs(reduced["tcfg"])
    a, b = TP.init_params(3, defs), TP.init_params(3, defs)
    c = TP.init_params(4, defs)
    la, lb, lc = TP.tree_leaves(a), TP.tree_leaves(b), TP.tree_leaves(c)
    assert all(np.array_equal(x, y) for x, y in zip(la, lb))
    assert any(not np.array_equal(x, y) for x, y in zip(la, lc))
    blk = a["stages"][1]["conv_blocks"][0] if a["stages"][1]["conv_blocks"] \
        else a["stages"][0]["conv_blocks"][0]
    assert np.all(blk["gamma"] == 1) and np.all(blk["pw1_b"] == 0)
    w = a["head_w"]
    assert abs(w.std() * np.sqrt(w.shape[0]) - 1) < 0.15      # fan-in scaling
    p = TP.init_params(3, defs, perturb=0.05)
    assert 0 < np.abs(p["head_b"]).max() < 0.5
    for leaf, d in zip(la, TP.tree_leaves(defs)):
        assert leaf.shape == tuple(d.shape) and leaf.dtype == np.float32


def test_from_jax_params_checks_structure_and_shapes(reduced):
    defs = TE.param_defs(reduced["tcfg"])
    good = TP.from_jax_params(reduced["init"], defs, device="cpu")
    assert good["stages"][0]["down_w"].shape == (4, 4, 3, 16)
    assert good["stages"][1]["sdta_blocks"][0]["temp"].shape == (2, 1, 1)
    bad = jax.tree.map(lambda a: a, reduced["init"])
    bad["head_w"] = bad["head_w"][:, :-1]
    with pytest.raises(ValueError, match="head_w"):
        TP.from_jax_params(bad, defs, device="cpu")
    missing = dict(reduced["init"])
    del missing["head_b"]
    with pytest.raises(ValueError):
        TP.from_jax_params(missing, defs, device="cpu")


def test_entry_points_default_to_the_card_and_raise_without_one(reduced):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.from_jax_params(reduced["init"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.EdgeNeXt(reduced["tcfg"], reduced["init"])


# ---------------------------------------------------------------------------
# helpers and blocks against their JAX counterparts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,scales", [(48, 1), (96, 2), (160, 3), (304, 4),
                                      (32, 2), (50, 4)])
def test_split_widths_match_jax(c, scales):
    assert TE._split_widths(c, scales) == JE._split_widths(c, scales)


def test_layer_norm_matches_jax():
    r = np.random.default_rng(2)
    x = r.standard_normal((3, 7, 24)).astype(np.float32) * 3 + 1
    s = r.standard_normal(24).astype(np.float32)
    b = r.standard_normal(24).astype(np.float32)
    want = JE.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    got = TE.layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                        torch.from_numpy(b))
    _close(got.numpy(), want, 3e-5)


@pytest.mark.parametrize("k,cin,cout", [(4, 3, 16), (2, 16, 24)])
def test_patchify_conv_matches_jax(k, cin, cout):
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 8, 12, cin)).astype(np.float32)
    w = r.standard_normal((k, k, cin, cout)).astype(np.float32) * 0.2
    b = r.standard_normal(cout).astype(np.float32)
    want = JE.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=k,
                     padding="VALID")
    got = TE.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b), stride=k, padding="VALID")
    _close(got.numpy(), want, 3e-5)


def test_conv2d_refuses_what_is_not_ported():
    x, w, b = torch.zeros(1, 8, 8, 3), torch.zeros(3, 3, 3, 4), torch.zeros(4)
    with pytest.raises(NotImplementedError):
        TE.conv2d(x, w, b, stride=1, padding="SAME")


@pytest.mark.parametrize("chunks", [0, 4])
def test_ibn_mlp_matches_jax(reduced, chunks):
    bp = reduced["rand"]["stages"][0]["conv_blocks"][0]
    x = np.random.default_rng(4).standard_normal((2, 5, 5, 16)).astype(np.float32)
    want = JE._ibn_mlp(_jnp_tree(bp), jnp.asarray(x), chunks)
    got = TE._ibn_mlp(_t_tree(bp), torch.from_numpy(x), chunks)
    _close(got.numpy(), want)


def test_conv_encoder_block_matches_jax(reduced):
    bp = reduced["rand"]["stages"][0]["conv_blocks"][0]
    x = np.random.default_rng(5).standard_normal((2, 8, 8, 16)).astype(np.float32)
    want = JE.conv_encoder_block(_jnp_tree(bp), jnp.asarray(x))
    got = TE.conv_encoder_block(_t_tree(bp), torch.from_numpy(x))
    _close(got.numpy(), want)


def test_xca_matches_jax(reduced):
    bp = reduced["rand"]["stages"][2]["sdta_blocks"][0]
    x = np.random.default_rng(6).standard_normal((2, 16, 32)).astype(np.float32)
    want = JE.xca(_jnp_tree(bp), jnp.asarray(x), 2)
    got = TE.xca(_t_tree(bp), torch.from_numpy(x), 2)
    _close(got.numpy(), want)


@pytest.mark.parametrize("stage,scales", [(1, 1), (2, 2), (3, 2)])
def test_sdta_block_matches_jax(reduced, stage, scales):
    cfg = reduced["cfg"]
    bp = reduced["rand"]["stages"][stage]["sdta_blocks"][0]
    c = cfg.dims[stage]
    x = np.random.default_rng(7).standard_normal((2, 4, 4, c)).astype(np.float32)
    want = JE.sdta_block(_jnp_tree(bp), jnp.asarray(x), cfg.heads, scales)
    got = TE.sdta_block(_t_tree(bp), torch.from_numpy(x), cfg.heads, scales)
    _close(got.numpy(), want)


def test_sdta_cascade_with_a_narrower_last_split():
    """160 channels over 3 scales split 54/54/52, as in stage 3 of
    EdgeNeXt-S.  The reference's cascade adds a 54-wide tensor to a
    52-wide one and raises; the port carries the common channels."""
    c, heads, scales = 20, 2, 3           # widths 7, 7, 6
    assert TE._split_widths(c, scales) == [7, 7, 6]
    defs = TE._sdta_defs(c, heads, scales, 4)
    bp = _t_tree(TP.init_params(8, defs, perturb=0.1))
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 4, 4, c)).astype(np.float32))
    got = TE.sdta_block(bp, x, heads, scales)
    assert got.shape == x.shape and torch.isfinite(got).all()
    # the cascade by hand
    s0, s1, s2 = x[..., :7], x[..., 7:14], x[..., 14:]
    d1 = tref.depthwise_conv2d_ref(s1, bp["dw"][0]["w"], bp["dw"][0]["b"])
    d2 = tref.depthwise_conv2d_ref(s2 + d1[..., :6], bp["dw"][1]["w"],
                                   bp["dw"][1]["b"])
    h = torch.cat([s0, d1, d2], -1).reshape(1, 16, c)
    a = TE.xca(bp, TE.layer_norm(h, bp["ln_x"]["scale"], bp["ln_x"]["bias"]),
               heads)
    h = h + bp["gamma_x"] * a
    m = TE._ibn_mlp(bp, TE.layer_norm(h, bp["ln_m"]["scale"],
                                      bp["ln_m"]["bias"]))
    want = (h + bp["gamma_m"] * m).reshape(1, 4, 4, c)
    _close(got.numpy(), want.numpy(), 1e-6)
    with pytest.raises(TypeError):
        JE.sdta_block(_jnp_tree(jax.tree.map(lambda t: t.numpy(), bp)),
                      jnp.asarray(x.numpy()), heads, scales)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weights", ["init", "rand"])
def test_forward_matches_jax(reduced, weights):
    p = reduced[weights]
    want = JE.forward(reduced["cfg"], _jnp_tree(p), jnp.asarray(reduced["images"]))
    model = TE.EdgeNeXt(reduced["tcfg"], p, device="cpu")
    got = model(torch.from_numpy(reduced["images"]))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 10)
    _close(got.numpy(), want)
    # the functional form on the carried-over tree is the same computation
    fn = TE.forward(reduced["tcfg"], _t_tree(p), torch.from_numpy(reduced["images"]))
    np.testing.assert_array_equal(fn.numpy(), got.numpy())


def test_forward_ibn_chunks_equal(reduced):
    model = TE.EdgeNeXt(reduced["tcfg"], reduced["rand"], device="cpu")
    x = torch.from_numpy(reduced["images"])
    _close(model(x, ibn_chunks=4).numpy(), model(x).numpy(), 2e-5)
    want = JE.forward(reduced["cfg"], _jnp_tree(reduced["rand"]),
                      jnp.asarray(reduced["images"]), ibn_chunks=4)
    _close(model(x, ibn_chunks=4).numpy(), want)


class _Recorder:
    """The plain versions under the names of ``ops``, recording each call."""

    def __init__(self):
        self.calls = {"fused_ibn": [], "flash_attention": [],
                      "depthwise_conv2d": []}

    def fused_ibn(self, x, w1, w2, wg=None, **kw):
        self.calls["fused_ibn"].append((x, w1, w2, wg, kw))
        return tref.PLAIN.fused_ibn(x, w1, w2, wg, **kw)

    def flash_attention(self, q, k, v, **kw):
        self.calls["flash_attention"].append((q, k, v, kw))
        return tref.PLAIN.flash_attention(q, k, v, **kw)

    def depthwise_conv2d(self, x, w, b, **kw):
        self.calls["depthwise_conv2d"].append((x, w, b))
        return tref.PLAIN.depthwise_conv2d(x, w, b)


def test_kernel_routed_composition_with_plain_versions(reduced):
    """Every depthwise conv, IBN MLP and XCA goes through the kernels'
    entry points, in the form the kernels take (bias folded in as an input
    row, XCA as non-causal attention at scale 1 with temp in q, dense
    operands), and with the plain versions in their place the logits are
    those of the JAX model."""
    cfg = reduced["tcfg"]
    rec = _Recorder()
    model = TE.EdgeNeXt(cfg, reduced["rand"], device="cpu", kernels=rec)
    got = model(torch.from_numpy(reduced["images"]))
    want = JE.forward(reduced["cfg"], _jnp_tree(reduced["rand"]),
                      jnp.asarray(reduced["images"]))
    _close(got.numpy(), want)
    default = TE.EdgeNeXt(cfg, reduced["rand"], device="cpu")
    assert default.kernels is tops
    np.testing.assert_array_equal(
        default(torch.from_numpy(reduced["images"])).numpy(), got.numpy())

    assert {k: len(v) for k, v in rec.calls.items()} == \
        TE.kernel_launches_per_forward(cfg)
    dims = set(cfg.dims)
    for x, w1, w2, wg, kw in rec.calls["fused_ibn"]:
        c = x.shape[-1] - 1
        assert c in dims and w1.shape == (c + 1, 4 * c) and w2.shape == (4 * c, c)
        assert wg is None and kw == {"activation": "gelu"}
        assert torch.all(x[..., -1] == 1) and x.is_contiguous()
    for q, k, v, kw in rec.calls["flash_attention"]:
        assert kw == {"causal": False, "scale": 1.0}
        B, h, s, n = q.shape
        assert h == cfg.heads and h * s in dims and k.shape == v.shape == q.shape
        assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
        # k rows are unit vectors over the tokens; q rows carry temp[h]
        _close(torch.linalg.vector_norm(k, dim=-1).numpy(), 1.0, 1e-4)
    from repro_torch.kernels.depthwise_conv import _pixel_stride
    for x, w, b in rec.calls["depthwise_conv2d"]:
        assert w.shape[2] == x.shape[3] == b.shape[0]
        _pixel_stride(x)          # a layout the CUDA kernel takes as it is
    assert any(not x.is_contiguous() for x, _, _ in rec.calls["depthwise_conv2d"])


def test_full_width_launch_counts():
    assert TE.kernel_launches_per_forward(tcfg.CONFIG) == {
        "fused_ibn": 18, "depthwise_conv2d": 21, "flash_attention": 3}


def test_module_state_names_follow_the_tree(reduced):
    model = TE.EdgeNeXt(reduced["tcfg"], reduced["init"], device="cpu")
    names = set(model.state_dict())
    assert "weights.stages/0/conv_blocks/0/dw_w" in names
    assert "weights.stages/2/sdta_blocks/0/dw/0/w" in names
    assert "weights.head_ln/scale" in names
    assert len(names) == len(TP.tree_leaves(TE.param_defs(reduced["tcfg"])))
    assert not any(p.requires_grad for p in model.parameters())
    with pytest.raises(ValueError, match="images on"):
        model(torch.zeros(1, 32, 32, 3, device="meta"))


def test_serve_answers_each_request(reduced):
    model = TE.EdgeNeXt(reduced["tcfg"], reduced["rand"], device="cpu")
    x = torch.from_numpy(reduced["images"])
    logits, ms = serve(model, [x, x[:1], x])
    assert [tuple(o.shape) for o in logits] == [(2, 10), (1, 10), (2, 10)]
    assert len(ms) == 3 and all(t > 0 for t in ms)
    np.testing.assert_array_equal(logits[0].numpy(), logits[2].numpy())
    _close(logits[1].numpy(), logits[0][:1].numpy(), 1e-5)


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)[\s.])", re.M)
    assert len(_port_sources()) >= 15
    for path in _port_sources():
        hit = pat.search(path.read_text())
        assert hit is None, f"{path.relative_to(ROOT)}: {hit.group(0).strip()}"


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    code = ("import sys, torch; import repro_torch.models.edgenext, "
            "repro_torch.serve_edgenext, repro_torch.kernels._build as b; "
            "import repro_torch.launch.mesh, repro_torch.launch.train, "
            "repro_torch.runtime.sharding, repro_torch.runtime.collectives, "
            "repro_torch.runtime.pipeline, repro_torch.models.actshard, "
            "repro_torch.models.moe_sharded, repro_torch.optim.compression, "
            "repro_torch.checkpoint.store; "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules; "
            "assert not torch.cuda.is_initialized(); "
            "assert b._lib is None and b.build_seconds is None; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
