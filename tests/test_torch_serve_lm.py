"""``repro_torch.serve_lm`` (the port of ``examples/serve_lm.py``) against
the example's ``serve`` in the JAX package, on the CPU.

For each of the example's five archs at ``reduced`` size: the example's
path as it is written there (``init_params`` at ``PRNGKey(0)``, the batch
from ``default_rng(7)``, ``jax.jit`` of ``build_prefill_step(cfg,
decode_len=prompt + gen)`` and of ``build_decode_step`` with the cache
donated, greedy decode from token 0) and the port's ``serve`` on the same
weights and batch, with ``gen`` cut to 4: the prefill's last hidden state
and each decode step's logits within 2e-4 (1 + |b|), the JAX tests'
attention tolerance, and the same greedy tokens.  That covers the
reference's quirks the port keeps: olmo-1b's decode written past its
48-slot cache (clamped to the last slot) and qwen3-moe's decode of 4
tokens dropping claims at an expert capacity of 1.  Then the module's own
contract.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import get_module as j_get_module
from repro.models import params as JP
from repro.runtime import build_decode_step as j_build_decode_step
from repro.runtime import build_prefill_step as j_build_prefill_step
from repro_torch import serve_lm as sl

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4
GEN = 4


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL, err_msg=err_msg)


def _jax_serve(arch, gen, batch_size=4, prompt_len=48):
    """The example's ``serve`` for ``arch`` -> (its parameters as numpy, the
    batch as numpy, the last hidden state, each decode step's logits, the
    tokens [B, gen])."""
    cfg = jreduced(jget(arch))
    params = JP.init_params(jax.random.PRNGKey(0), j_get_module(cfg).param_defs(cfg))
    rng = np.random.default_rng(7)
    batch = {"tokens": jnp.asarray(rng.integers(
        0, cfg.vocab_size, (batch_size, prompt_len), dtype=np.int32))}
    if cfg.embedding_inputs:
        batch["inputs_embeds"] = jnp.asarray(rng.standard_normal(
            (batch_size, prompt_len, cfg.d_model)).astype(np.float32))
        if cfg.family == "audio":
            batch["tokens"] = batch["tokens"][:, :1]
    prefill = jax.jit(j_build_prefill_step(cfg, decode_len=prompt_len + gen))
    decode = jax.jit(j_build_decode_step(cfg), donate_argnums=(1,))
    tree = jax.tree.map(lambda a: np.asarray(a), params)
    last, cache = prefill(params, batch)
    tok = jnp.zeros((batch_size, 1), jnp.int32)
    logits, toks = [], []
    for _ in range(gen):
        tok1, lg, cache = decode(params, cache, {"tokens": tok})
        tok = tok1[:, None]
        logits.append(np.asarray(lg))
        toks.append(np.asarray(tok1))
    return (tree, {k: np.asarray(v) for k, v in batch.items()}, np.asarray(last),
            logits, np.stack(toks, 1))


@pytest.mark.parametrize("arch", sl.ARCHS)
def test_serve_gives_the_jax_examples_logits(arch):
    """The port's ``serve`` on the JAX example's weights and batch: the last
    hidden state and 4 decode steps' logits within 2e-4 (1 + |b|), the
    tokens equal."""
    tree, batch, last, logits, toks = _jax_serve(arch, GEN)
    lines = []
    res = sl.serve(arch, gen=GEN, device="cpu", params=tree, out=lines.append)
    for k, v in batch.items():
        np.testing.assert_array_equal(res["batch"][k].numpy(), v, err_msg=k)
    _close(res["last_hidden"].numpy(), last, "last hidden")
    assert len(res["logits"]) == GEN
    for i, (got, want) in enumerate(zip(res["logits"], logits)):
        _close(got.numpy(), want, f"decode step {i}")
    np.testing.assert_array_equal(res["tokens"].numpy(), toks)
    cfg = res["cfg"]
    assert lines == [f"{arch:24s} [{cfg.family:6s}] prefill={res['prefill_ms']:6.0f}ms  "
                     f"decode={res['decode_ms_per_token']:6.1f} ms/tok  "
                     f"first-seq: {toks[0][:8].tolist()}"]


def test_teacher_forced_decode_takes_the_given_tokens():
    """``tokens_in`` feeds the decode steps the given tokens: fed the greedy
    run's own tokens, it repeats that run; fed others, its first step (from
    token 0) is the same and its second is not."""
    free = sl.serve("rwkv6-1.6b", gen=GEN, device="cpu", out=None)
    forced = sl.serve("rwkv6-1.6b", gen=GEN, device="cpu", tokens_in=free["tokens"],
                      out=None)
    for a, b in zip(forced["logits"], free["logits"]):
        assert torch.equal(a, b)
    assert torch.equal(forced["tokens"], free["tokens"])
    other = sl.serve("rwkv6-1.6b", gen=GEN, device="cpu",
                     tokens_in=(free["tokens"] + 1) % free["cfg"].vocab_size, out=None)
    assert torch.equal(other["logits"][0], free["logits"][0])
    assert not torch.equal(other["logits"][1], free["logits"][1])


def test_the_example_constants_are_the_references():
    """The module's archs, batch, prompt, generation and seeds are the
    example's."""
    assert sl.ARCHS == ("olmo-1b", "qwen3-moe-30b-a3b", "rwkv6-1.6b",
                        "recurrentgemma-2b", "seamless-m4t-large-v2")
    assert (sl.BATCH, sl.PROMPT_LEN, sl.GEN) == (4, 48, 24)
    assert (sl.DATA_SEED, sl.PARAM_SEED) == (7, 0)


def test_cli_on_the_cpu_prints_a_line_an_arch(capsys):
    out = sl.main(["--device", "cpu", "--arch", "olmo-1b", "seamless-m4t-large-v2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == ["olmo-1b", "seamless-m4t-large-v2"]
    assert "[dense ] prefill=" in lines[0] and "[audio ] prefill=" in lines[1]
    for res in out.values():
        assert res["tokens"].shape == (sl.BATCH, sl.GEN)
        assert ((res["tokens"] >= 0) & (res["tokens"] < res["cfg"].vocab_size)).all()


def test_module_loads_no_jax():
    code = ("import sys; import repro_torch.serve_lm; "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_raises_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        sl.main(["--arch", "olmo-1b"])
