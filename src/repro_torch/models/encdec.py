"""Encoder-decoder LM (Whisper backbone; port of ``repro.models.encdec``).

The conv audio frontend is a stub: the encoder takes precomputed frame
embeddings (B, S_enc, d_model), adds the fixed sinusoidal table and runs a
non-causal stack of ``cfg.enc_pattern`` blocks, then its final norm. The
decoder is a decoder-only LM (``init_lm``'s tree under "dec": token
embeddings, learned positions, the head) whose layers add cross-attention
over the encoder output. Params: {"enc": {"final_norm", "stack"}, "dec":
...}, the JAX package's key paths.

Serving is contiguous (``encdec_init_cache``): ``encdec_prefill`` encodes
the frames, fills every decoder layer's cross cache with the encoder
output's K/V and ingests the prompt; each ``encdec_decode`` step reads
those K/V as they are. There is no paged form (the JAX package has none
either), so whisper does not go through the continuous engine.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.norms import apply_norm, init_norm
from repro_torch.models.rope import sinusoidal_positions
from repro_torch.models.transformer import (_arange_positions, _embed, _head,
                                            _init_stacked, _run_stack,
                                            init_contiguous_cache, init_lm,
                                            token_loss)


def enc_config(cfg: ModelConfig) -> ModelConfig:
    return cfg.replace(pattern=cfg.enc_pattern, n_repeats=cfg.n_enc_repeats,
                       prefix_pattern=(), enc_dec=False, pos_emb="none",
                       attn_window=None, frontend="none")


def dec_config(cfg: ModelConfig) -> ModelConfig:
    return cfg.replace(enc_dec=False, frontend="none")


def init_encdec(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Seeded float params: the encoder's blocks and final norm drawn from
    a ``torch.Generator`` seeded with ``seed``, then the decoder
    (``init_lm`` of ``dec_config``, seeded with ``seed + 1``)."""
    cfg.validate()
    dev = resolve_device(device)
    ecfg = enc_config(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    enc = {"final_norm": init_norm(ecfg, ecfg.d_model, dev),
           "stack": {f"p{j}": _init_stacked(ecfg, spec, gen, dev)
                     for j, spec in enumerate(ecfg.pattern)}}
    return {"enc": enc, "dec": init_lm(dec_config(cfg), seed + 1, dev)}


def encoder_input(frames: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The encoder's first block's input: the frame embeddings (B, S_enc,
    d) plus the fixed sinusoidal table, both cast to ``dtype`` (the
    config's ``adtype``) first."""
    _, s, d = frames.shape
    return frames.to(dtype) + sinusoidal_positions(
        s, d, frames.device)[None].to(dtype)


def encode(cfg: ModelConfig, params: dict,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_enc, d) precomputed embeddings (conv frontend stub) ->
    the encoder output (B, S_enc, d)."""
    ecfg = enc_config(cfg)
    b, s, _ = frames.shape
    x = encoder_input(frames, ecfg.adtype)
    positions = torch.arange(s, dtype=torch.int32,
                             device=frames.device)[None].expand(b, s)
    x, _ = _run_stack(ecfg, params["enc"], x, positions=positions,
                      causal=False)
    return apply_norm(ecfg, params["enc"]["final_norm"], x)


def _decoder(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
             positions: torch.Tensor, **kw):
    """The decoder stack over ``tokens`` at ``positions`` (``kw``: cache,
    decode, enc_out); returns (hidden states, aux)."""
    dcfg = dec_config(cfg)
    x = _embed(dcfg, params["dec"], tokens, positions)
    return _run_stack(dcfg, params["dec"], x, positions=positions, **kw)


def encdec_forward(cfg: ModelConfig, params: dict, frames: torch.Tensor,
                   tokens: torch.Tensor):
    """Teacher-forced forward. Returns (decoder logits (B, S, V) f32,
    aux)."""
    enc_out = encode(cfg, params, frames)
    x, aux = _decoder(cfg, params, tokens, _arange_positions(tokens, None),
                      enc_out=enc_out, train=True)
    return (_head(dec_config(cfg), params["dec"], x),
            torch.as_tensor(aux, dtype=torch.float32, device=x.device))


def encdec_loss(cfg: ModelConfig, params: dict, batch: dict):
    """Next-token cross-entropy of the decoder. batch: frames, tokens,
    labels, optional mask. Returns (loss, {"nll", "aux"})."""
    logits, aux = encdec_forward(cfg, params, batch["frames"],
                                 batch["tokens"])
    return token_loss(logits, batch, aux)


def encdec_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                      enc_len: int, device="cuda") -> dict:
    """The decoder's contiguous self-attention caches of ``max_len`` and
    cross caches of ``enc_len`` encoder positions."""
    return init_contiguous_cache(dec_config(cfg), batch, max_len,
                                 resolve_device(device), enc_len=enc_len)


def encdec_prefill(cfg: ModelConfig, params: dict, frames: torch.Tensor,
                   tokens: torch.Tensor, cache: dict) -> torch.Tensor:
    """Encode the frames and ingest the decoder prompt (positions 0..S-1),
    filling ``cache`` in place. Returns the last token's logits (B, V)."""
    enc_out = encode(cfg, params, frames)
    x, _ = _decoder(cfg, params, tokens, _arange_positions(tokens, None),
                    cache=cache, enc_out=enc_out)
    return _head(dec_config(cfg), params["dec"], x[:, -1:, :])[:, 0, :]


def encdec_decode(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                  cache: dict, positions: torch.Tensor) -> torch.Tensor:
    """One decoder step (tokens, positions (B, 1)) against the cached self
    and cross K/V. Returns logits (B, V)."""
    x, _ = _decoder(cfg, params, tokens, positions, cache=cache,
                    decode=True)
    return _head(dec_config(cfg), params["dec"], x)[:, 0, :]
