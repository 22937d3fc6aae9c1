"""The port's encoder-decoder (whisper) and vision-stub (qwen2-vl) LMs
against the reference, on the CPU.

``layers.sinusoidal_positions`` against the reference's; ``LM.encode``
(the non-causal encoder stack over audio frames with sinusoidal positions)
against the reference's ``encode``; ``LM._positions`` with a fused patch
prefix (M-RoPE grid positions (0, row, column)) and at decode offsets, and
``_embed_inputs``' early fusion, against the reference's. Then the whisper
SMOKE model (cross-attention in every decoder layer, the encoder's output
kept in the caches) and the qwen2-vl SMOKE model end to end
(``tests/_lm_parity.py``), with audio frames and patch embeddings made from
a seed with numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _lm_parity as P  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402

ARCHS = ("whisper-medium", "qwen2-vl-7b")


@pytest.mark.parametrize("seq,d,offset", [(1, 8, 0), (30, 64, 0),
                                          (1500, 1024, 0), (7, 16, 11)])
def test_sinusoidal_positions_match_reference(seq, d, offset):
    """Each package's f32 ``exp`` may round an inverse frequency (<= 1)
    one ulp (2^-23) apart, which moves an angle by up to its position
    times that, and the angle's own rounding is under 2^-13 below 4096:
    the sines and cosines agree within that."""
    got = t_layers.sinusoidal_positions(seq, d, offset)
    want = np.asarray(j_layers.sinusoidal_positions(seq, d, offset))
    assert got.dtype == torch.float32 and got.shape == want.shape
    atol = (seq + offset) * 2.0 ** -23 + 2.0 ** -13
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_encode_matches_reference():
    jlm, params, lm = P.models("whisper-medium")
    cfg = lm.cfg
    audio = np.random.default_rng(3).normal(
        size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    want = jax.jit(jlm.encode)(params, jnp.asarray(audio))
    with torch.no_grad():
        got = lm.encode(torch.from_numpy(audio))
    assert got.shape == (2, cfg.encoder_seq, cfg.d_model)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("offset", [0, 5, 40])
def test_positions_and_patch_fusion_match_reference(offset):
    jlm, params, lm = P.models("qwen2-vl-7b")
    cfg = lm.cfg
    b = P.batch(cfg, 2, 24, 4)
    want = np.asarray(jlm._positions(P.as_jax(b), 2, 24, offset=offset))
    got = lm._positions(P.as_torch(b), 2, 24, offset=offset)
    assert got.shape == (2, 24, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    if offset == 0:       # the patch prefix: t = 0, then the grid's h, w
        assert (got[:, :cfg.num_patches, 0] == 0).all()
        assert int(got[0, cfg.num_patches, 0]) == cfg.num_patches
    x = lm._embed_inputs(P.as_torch(b))
    jx = np.asarray(jlm._embed_inputs(params, P.as_jax(b)))
    np.testing.assert_allclose(x.numpy(), jx, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        x[:, :cfg.num_patches].numpy(),
        b["patch_embeds"] * np.float32(cfg.d_model ** 0.5), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    P.check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    P.check_prefill_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    P.check_decode_matches_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_caches_carry_across(arch):
    P.check_params_and_caches(arch)
    _, _, lm = P.models(arch)
    sd = lm.state_dict()
    if lm.cfg.encoder_decoder:
        assert len(lm.encoder) == lm.cfg.encoder_layers
        assert "encoder.0.mix.wq" in sd and "layers.0.cross.wq" in sd
        assert "layers.0.norm_x.scale" in sd and "encoder.0.cross.wq" not in sd
    else:
        assert len(lm.encoder) == 0 and "layers.0.cross.wq" not in sd


def test_decode_reads_the_encoder_output_it_is_given():
    """decode_step's ``encoder_out`` argument overrides the caches' (the
    reference's keyword): other encoder states give other logits, the
    caches' own the same ones."""
    _, _, lm = P.models("whisper-medium")
    b = P.as_torch(P.batch(lm.cfg, 2, 9, 6))
    with torch.no_grad():
        _, caches = lm.prefill(dict(b, tokens=b["tokens"][:, :8]),
                               max_len=9)
        tok = b["tokens"][:, 8:9]
        kept = [dict(c) for c in caches]
        same, _ = lm.decode_step(caches, tok, 8,
                                 encoder_out=caches.encoder_out)
        caches[:] = [dict(c) for c in kept]
        other, _ = lm.decode_step(caches, tok, 8,
                                  encoder_out=torch.zeros_like(
                                      caches.encoder_out))
        caches[:] = kept
        base, _ = lm.decode_step(caches, tok, 8)
    assert torch.equal(same, base)
    assert float((other - base).abs().max()) > 1e-3 * float(base.abs().max())
