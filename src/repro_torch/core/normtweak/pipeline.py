"""Norm-Tweaking PTQ pipeline — the paper's Algorithm 1 (port of
``repro.core.normtweak.pipeline``: decoder-only LMs — dense, MoE, MLA,
Mamba2, attention/Mamba hybrids and a VLM's patch-prefixed sequences —
and whisper's encoder-decoder, ``norm_tweak_ptq_encdec``).

Layer-by-layer over the model, the prefix blocks (DeepSeek's dense first
layer) first, then the repeats:
  1. the quantized stream qX feeds every layer (lines 4-7);
  2. the float output fOut_l is computed with float weights (line 8), from
     the float model's own stream ("fstream") or from qX ("qstream");
  3. the layer's linears are quantized (GPTQ/RTN/SmoothQuant/AWQ, line 9)
     from the inputs each linear sees on qX (taps);
  4. Adam updates ONLY the norm parameters against the channel-wise
     distribution loss for ``iters`` passes over the calibration set in
     sample-batch chunks (lines 11-15), with the depth-increasing LR of
     Eq. 3. The JAX package runs this loop as one jitted ``lax.scan``; here
     it is a Python loop over the same chunks in the same order
     (chunks 0..C-1, ``iters`` times), one backward pass each;
  5. qX advances through the final quantized layer.

Packed linears run the port's kernels in every forward here — the
dequant matmul, or the W8A8 matmul when ``act_bits == 8``, and their
expert-batched forms for an MoE block's experts — and the tweak
differentiates through them (models/linear.py says how). An MoE block's
calibration taps are its router input and (E, C, d) capacity buffers;
every call here is unpaged, so no token is masked out of routing. A
mamba block's taps are "mamba/in_proj" and "mamba/out_proj" (the gated
norm's output); its tweak moves "ln1" and the gated norm "gnorm" (and
"ln2" under an MLP or MoE) through autograd over the SSD scan. An
enc-dec decoder block's cross-attention taps "xattn/wk" and "xattn/wv"
are the encoder output, and its tweak moves "lnx" beside ln1 and ln2.
Two behaviours of the JAX package are kept as they are: every block runs
causally here, an encoder block too (``encode`` runs it non-causally),
and the tweak's loss runs a decoder block without the encoder output, so
its cross sub-layer attends over its own normed input (while the float
stream, the taps and the qX advance read the encoder output). Set
``tweak=False`` for the plain quantizer baseline.

Beside the JAX package's per-layer loss and LR, ``stats`` records each
layer's seconds in its forwards (float stream, taps, advance), in
quantization and in the tweak, synchronising the card around each phase.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.core.normtweak.losses import LOSSES
from repro_torch.core.normtweak.schedule import layer_lr
from repro_torch.core.quant.blockquant import quantize_block
from repro_torch.models.blocks import apply_block
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import dec_config, enc_config, encoder_input
from repro_torch.models.norms import apply_norm, is_norm_path
from repro_torch.models.transformer import (_arange_positions, _embed,
                                            get_block, num_blocks)
from repro_torch.optim.adam import adam_init, adam_update
from repro_torch.utils.tree import (tree_map, tree_merge, tree_partition,
                                    tree_stack)


# tokens a full-batch block apply (float stream, taps, qX advance) takes
# at a time: at the paper's 128 x 2048 calibration tokens one MLP
# intermediate of llama3.2-1b alone would be 8.6 GB in f32
APPLY_TOKENS = 1 << 15


@dataclasses.dataclass(frozen=True)
class NTConfig:
    method: str = "gptq"          # gptq | rtn | smoothquant | awq
    bits: int = 4
    group_size: int = -1          # -1 = per-channel; 64 for W2 (paper)
    act_bits: int = 0             # 8 for SmoothQuant W4A8
    tweak: bool = True            # False => plain PTQ baseline
    iters: int = 1                # passes over the calibration set (Table 6)
    lr0: float = 1e-5
    lr_scale: float = 10.0        # Eq. 3 depth scaling
    loss: str = "dist"            # dist | mse | kl (Table 9)
    target: str = "fstream"       # fstream: fOut_l from the float model's own
                                  # activations (Fig. 1's objective); qstream:
                                  # float layer applied to the quantized
                                  # stream (a literal Algorithm-1 line-8 read)
    sample_batch: int = 8         # calibration samples per tweak step
    damp: float = 0.01
    actorder: bool = False
    alpha: float = 0.5            # SmoothQuant migration strength


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _tweak_update(cfg, loss_name, norms, rest, opt_state, x, fout,
                  positions, lr):
    """One Adam step on the norm params for one sample-batch chunk. Only
    the norm leaves require gradients."""
    leaves = []

    def track(t):
        t = t.detach().requires_grad_(True)
        leaves.append(t)
        return t

    tracked = tree_map(track, norms)
    # the MoE aux loss is not part of the tweak's objective (as in the JAX
    # package)
    qout, _ = apply_block(cfg, tree_merge(tracked, rest), x,
                          positions=positions)
    loss = LOSSES[loss_name](fout, qout)
    grads = iter(torch.autograd.grad(loss, leaves))
    grad_tree = tree_map(lambda _: next(grads), tracked)
    new_norms, new_state = adam_update(grad_tree, opt_state, norms, lr=lr)
    return new_norms, new_state, loss.detach()


def tweak_block(cfg: ModelConfig, qbp: dict, qx: torch.Tensor,
                fout: torch.Tensor, positions: torch.Tensor, nt: NTConfig,
                lr: float):
    """Lines 11-15 for one quantized block: ``nt.iters`` passes of Adam over
    the sample-batch chunks of (qx, fout). Returns (block with tweaked
    norms, the last chunk's loss)."""
    norms, rest = tree_partition(qbp, is_norm_path)
    opt_state = adam_init(norms)
    n = qx.shape[0]
    sb = max(1, min(nt.sample_batch, n))
    last_loss = torch.zeros((), device=qx.device)
    for _ in range(nt.iters):                                    # line 11
        for s0 in range(0, n, sb):
            norms, opt_state, last_loss = _tweak_update(
                cfg, nt.loss, norms, rest, opt_state, qx[s0:s0 + sb],
                fout[s0:s0 + sb], positions[s0:s0 + sb], lr)
    return tree_merge(norms, rest), last_loss


def tweak_layers(cfg: ModelConfig, blocks: list, x0: torch.Tensor,
                 nt: NTConfig, *, enc_out: Optional[torch.Tensor] = None,
                 layer_offset: int = 0,
                 total_layers: Optional[int] = None,
                 log: Optional[Callable[[str], None]] = None):
    """Core loop over an ordered list of blocks. Returns (qblocks, qX,
    stats). x0: (n_samples, seq, d) activations entering the first
    block; ``enc_out`` (n_samples, enc_len, d): the encoder output an
    enc-dec decoder's cross-attention reads in the block applies (not in
    the tweak's loss, as in the JAX package). Eq. 3's lr takes layer
    ``layer_offset + i`` of ``total_layers``."""
    total_layers = total_layers or len(blocks)
    n, s, _ = x0.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x0.device)[None].expand(n, s)
    qx = x0
    fx = x0  # float stream (used when nt.target == "fstream")
    qblocks = []
    stats = {"layer_loss": [], "layer_lr": [], "layer_forward_s": [],
             "layer_quant_s": [], "layer_tweak_s": []}

    @torch.no_grad()
    def block_apply_full(bp, x, taps=None):
        """The block over all samples: in chunks of APPLY_TOKENS tokens
        (each sample's function is the same whichever chunk it is in),
        except an MoE block, whose capacity routing counts every token of
        the call. Chunked taps are concatenated along the samples, a tensor
        that several keys share (wq, wk, wv's input) once."""
        step = n if "moe" in bp else max(1, APPLY_TOKENS // s)
        if step >= n:
            return apply_block(cfg, bp, x, positions=positions,
                               enc_out=enc_out, taps=taps)[0]
        outs, parts = [], {}
        for s0 in range(0, n, step):
            ctaps = None if taps is None else {}
            outs.append(apply_block(
                cfg, bp, x[s0:s0 + step], positions=positions[s0:s0 + step],
                enc_out=None if enc_out is None else enc_out[s0:s0 + step],
                taps=ctaps)[0])
            for key, t in (ctaps or {}).items():
                parts.setdefault(key, []).append(t)
        joined = {}
        for key, ts in parts.items():
            ident = tuple(map(id, ts))
            if ident not in joined:
                joined[ident] = torch.cat(ts)
            taps[key] = joined[ident]
        return torch.cat(outs)

    for li, bp in enumerate(blocks):
        gi = layer_offset + li
        _sync(x0)
        t0 = time.perf_counter()
        if nt.target == "fstream":
            fx = block_apply_full(bp, fx)                       # float stream
            fout = fx
        else:
            fout = block_apply_full(bp, qx)                     # line 8
        taps: dict = {}
        block_apply_full(bp, qx, taps=taps)                     # capture X
        _sync(x0)
        t1 = time.perf_counter()
        qbp = quantize_block(bp, taps, method=nt.method, bits=nt.bits,
                             group_size=nt.group_size, act_bits=nt.act_bits,
                             alpha=nt.alpha, damp=nt.damp,
                             actorder=nt.actorder)              # lines 9-10
        del taps
        _sync(x0)
        t2 = time.perf_counter()
        if nt.tweak:
            lr = layer_lr(nt.lr0, nt.lr_scale, gi, total_layers)  # Eq. 3
            qbp, last_loss = tweak_block(cfg, qbp, qx, fout, positions, nt,
                                         lr)
            stats["layer_loss"].append(float(last_loss))
            stats["layer_lr"].append(lr)
        _sync(x0)
        t3 = time.perf_counter()
        qblocks.append(qbp)
        qx = block_apply_full(qbp, qx)                          # line 6
        _sync(x0)
        stats["layer_forward_s"].append(t1 - t0 + time.perf_counter() - t3)
        stats["layer_quant_s"].append(t2 - t1)
        stats["layer_tweak_s"].append(t3 - t2)
        if log:
            log(f"layer {gi + 1}/{total_layers} done "
                f"({'tweaked' if nt.tweak else 'quantized'})")
    return qblocks, qx, stats


def _restack(cfg: ModelConfig, params: dict, qblocks: list) -> dict:
    """The quantized blocks back into the tree: the prefix blocks as they
    are, then the repeats stacked."""
    out = dict(params)
    n_pre = len(cfg.prefix_pattern)
    if n_pre:
        out["prefix"] = {str(i): qblocks[i] for i in range(n_pre)}
    pl = len(cfg.pattern)
    out["stack"] = {f"p{j}": tree_stack([qblocks[n_pre + r * pl + j]
                                         for r in range(cfg.n_repeats)])
                    for j in range(pl)}
    return out


def norm_tweak_ptq(cfg: ModelConfig, params: dict,
                   calib_tokens: torch.Tensor, nt: NTConfig,
                   ext_embeds: Optional[torch.Tensor] = None,
                   log: Optional[Callable[[str], None]] = None):
    """Quantize a decoder-only LM with Norm-Tweaking. Returns (qparams,
    stats). calib_tokens: (n_samples, token_length) on the params' device
    — the paper uses 128 x 2048 self-generated samples (see
    core/calibration); ``ext_embeds`` (n_samples, P, d): a VLM's patch
    embeddings ahead of each sample's tokens."""
    positions = _arange_positions(calib_tokens, ext_embeds)
    x0 = _embed(cfg, params, calib_tokens, positions, ext_embeds)
    blocks = [get_block(cfg, params, i) for i in range(num_blocks(cfg))]
    qblocks, _, stats = tweak_layers(cfg, blocks, x0, nt, log=log)
    return _restack(cfg, params, qblocks), stats


def norm_tweak_ptq_encdec(cfg: ModelConfig, params: dict,
                          calib_frames: torch.Tensor,
                          calib_tokens: torch.Tensor, nt: NTConfig,
                          log: Optional[Callable[[str], None]] = None):
    """Whisper: tweak the encoder's layers on the frame stream, then the
    decoder's on the token stream, its cross-attention reading the
    *quantized* encoder's output (after its final norm). Eq. 3's lr runs
    over the encoder's and the decoder's layers as one depth. Returns
    (qparams, stats: the two halves' records joined, encoder first).
    calib_frames (n, S_enc, d); calib_tokens (n, S)."""
    ecfg, dcfg = enc_config(cfg), dec_config(cfg)
    x0 = encoder_input(calib_frames)
    n_enc, n_dec = num_blocks(ecfg), num_blocks(dcfg)
    total = n_enc + n_dec
    enc_blocks = [get_block(ecfg, params["enc"], i) for i in range(n_enc)]
    q_enc, q_enc_out, st1 = tweak_layers(ecfg, enc_blocks, x0, nt,
                                         total_layers=total, log=log)
    q_enc_out = apply_norm(ecfg, params["enc"]["final_norm"], q_enc_out)
    positions = _arange_positions(calib_tokens, None)
    xd0 = _embed(dcfg, params["dec"], calib_tokens, positions)
    dec_blocks = [get_block(dcfg, params["dec"], i) for i in range(n_dec)]
    q_dec, _, st2 = tweak_layers(dcfg, dec_blocks, xd0, nt,
                                 enc_out=q_enc_out, layer_offset=n_enc,
                                 total_layers=total, log=log)
    qparams = dict(params)
    qparams["enc"] = _restack(ecfg, params["enc"], q_enc)
    qparams["dec"] = _restack(dcfg, params["dec"], q_dec)
    return qparams, {k: st1[k] + st2[k] for k in st1}
