"""Cross-frame attention aggregation (counterpart of
tscd_tpu/models/aggregation.py: DualBranchAttention, MCACore, MCAg2l;
reference post_trans.py:550,1109).

Each local frame's P proposals attend to its own frame plus every
global frame. The JAX package vmaps over local frames; here the local
frame is a batch axis written out. The fused branch (no score-window
mask) goes through the hand kernel `ops.kernels.fused_attention`; the
masked branch (`use_mask`) is plain tensor code.
"""

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..ops.kernels.fused_attention import fused_dual_attention

NEG = -1e9


def _split_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    B, N, C = x.shape
    return x.reshape(B, N, h, C // h).transpose(1, 2)      # (B, h, N, d)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, h, N, d = x.shape
    return x.transpose(1, 2).reshape(B, N, h * d)


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # eps 1e-12 under a max, as aggregation.py:42 (the matcher's differs)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=eps)


class AttnPieces(NamedTuple):
    out_cls: torch.Tensor     # (B, q, 2C) [attn V_cls | V_cls[:q]]
    out_reg: torch.Tensor     # (B, q, 2C)
    sim_round2: torch.Tensor  # (B, q, k) normalised cls similarity weights
    obj_round2: torch.Tensor  # (B, q, k) normalised reg similarity weights
    v_cls: torch.Tensor       # (B, k, C) merged value features
    v_reg: torch.Tensor       # (B, k, C)


class DualBranchAttention(nn.Module):
    """Shared attention core of Attention_mca_g2l (cross form): q from
    the first n_query tokens, k/v over all tokens."""

    def __init__(self, dim: int, num_heads: int = 4, scale: float = 25.0,
                 qkv_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.scale = scale
        self.q_cls_local = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv_cls = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.q_reg_local = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv_reg = nn.Linear(dim, 2 * dim, bias=qkv_bias)

    def attend(self, x_cls: torch.Tensor, x_reg: torch.Tensor,
               cls_score: Optional[torch.Tensor],
               fg_score: Optional[torch.Tensor], key_valid: torch.Tensor,
               n_query: int, sim_thresh: float = 0.75,
               use_mask: bool = False, conf_sim_thresh: float = 0.99
               ) -> AttnPieces:
        """x_*: (B, N, C); cls_score/fg_score/key_valid: (B, N)."""
        h = self.num_heads
        f32 = torch.float32
        k_cls, v_cls = self.kv_cls(x_cls).chunk(2, -1)
        k_reg, v_reg = self.kv_reg(x_reg).chunk(2, -1)
        qc0 = _split_heads(self.q_cls_local(x_cls[:, :n_query]), h)
        qr0 = _split_heads(self.q_reg_local(x_reg[:, :n_query]), h)
        kc0, vc = _split_heads(k_cls, h), _split_heads(v_cls, h)
        kr0, vr = _split_heads(k_reg, h), _split_heads(v_reg, h)
        vcn, vrn = _l2norm(vc), _l2norm(vr)
        kv = key_valid[:, None, :]

        cls_mask = None
        if not use_mask:
            score = (cls_score.to(f32) if cls_score is not None
                     else torch.ones_like(key_valid, dtype=f32))
            x, xr, attn = fused_dual_attention(qc0, kc0, vc, qr0, kr0, vr,
                                               score, key_valid, self.scale)
        else:
            qc, kc, qr, kr = map(_l2norm, (qc0, kc0, qr0, kr0))
            logits_cls = torch.einsum("bhqd,bhkd->bhqk", qc, kc) * self.scale
            logits_reg = torch.einsum("bhqd,bhkd->bhqk", qr, kr) * self.scale
            if cls_score is not None:
                logits_cls = logits_cls * cls_score.to(f32)[:, None, None, :]
            if cls_score is not None and fg_score is not None:
                # score-window mask on the CLS logits only; fg_mask joins
                # the round-2 sim_mask (post_trans.py:778,818)
                cs, fs = cls_score.to(f32), fg_score.to(f32)
                cls_mask = (cs[:, None, :] > cs[:, :n_query, None] - 0.1).to(f32)
                fg_mask = (fs[:, None, :] > fs[:, :n_query, None] - 0.1).to(f32)
                logits_cls = logits_cls * cls_mask[:, None]
                cls_mask = cls_mask * fg_mask
            kmask = torch.where(kv[:, None], 0.0, NEG).to(f32)
            attn = (torch.softmax(logits_cls + kmask, -1)
                    + torch.softmax(logits_reg + kmask, -1)) * 0.5
            x = torch.einsum("bhqk,bhkd->bhqd", attn, vc.to(f32))
            xr = torch.einsum("bhqk,bhkd->bhqd", attn, vr.to(f32))

        out_cls = torch.cat([_merge_heads(x), _merge_heads(vc[:, :, :n_query])], -1)
        out_reg = torch.cat([_merge_heads(xr), _merge_heads(vr[:, :, :n_query])], -1)

        # round-2 similarity masks (post_trans.py:803-824)
        raw_cls = torch.einsum("bhqd,bhkd->bqk", vcn[:, :, :n_query], vcn) / h
        raw_reg = torch.einsum("bhqd,bhkd->bqk", vrn[:, :, :n_query], vrn) / h
        sim_mask = ((raw_cls > sim_thresh) & kv).to(f32)
        if cls_mask is not None:
            sim_mask = sim_mask * cls_mask
        obj_mask = ((raw_reg > conf_sim_thresh) & kv).to(f32)

        sim_attn = attn.sum(1) / h
        sim_round2 = torch.softmax(
            torch.where(kv, sim_attn, torch.full_like(sim_attn, NEG)), -1)
        denom = (sim_mask * sim_round2).sum(-1, keepdim=True).clamp(min=1e-12)
        sim_round2 = sim_mask * sim_round2 / denom
        denom_o = (obj_mask * sim_round2).sum(-1, keepdim=True).clamp(min=1e-12)
        obj_round2 = obj_mask * sim_round2 / denom_o
        return AttnPieces(out_cls, out_reg, sim_round2, obj_round2,
                          _merge_heads(vc), _merge_heads(vr))


class MCACore(DualBranchAttention):
    """Attention_mca_g2l (post_trans.py:550): attention core + 2C->2C
    linear(s) + round-2 ("ave") pooling of raw V -> (B, q, 3C), the mode
    the TSCD exps run (tscd_base.py:58). Subclasses the
    core so the parameter names stay flat (`mca.q_cls_local`,
    `mca.linear`) as in the reference."""

    def __init__(self, dim: int, num_heads: int = 4, scale: float = 25.0,
                 reconf: bool = False):
        super().__init__(dim, num_heads, scale)
        self.reconf = reconf
        self.linear = nn.Linear(2 * dim, 2 * dim)
        if reconf:
            self.linear_reg = nn.Linear(2 * dim, 2 * dim)

    def forward(self, x_cls, x_reg, cls_score, fg_score, key_valid, n_query,
                sim_thresh=0.75, use_mask=False, conf_sim_thresh=0.99
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        p = self.attend(x_cls, x_reg, cls_score, fg_score, key_valid,
                        n_query, sim_thresh=sim_thresh, use_mask=use_mask,
                        conf_sim_thresh=conf_sim_thresh)
        out_cls = self.linear(p.out_cls)
        cls_feature = torch.cat([p.sim_round2 @ p.v_cls, out_cls], -1)
        reg_feature = (torch.cat([p.obj_round2 @ p.v_reg,
                                  self.linear_reg(p.out_reg)], -1)
                       if self.reconf else None)
        return cls_feature, reg_feature


class MCAg2l(nn.Module):
    """MCA_tscd_g2l_reg (post_trans.py:1109): local-frame proposals
    attend to own frame + all global frames."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int = 4,
                 scale: float = 25.0, reconf: bool = False):
        super().__init__()
        self.reconf = reconf
        self.mca = MCACore(in_dim, num_heads, scale, reconf)
        self.linear = nn.Linear(3 * in_dim, out_dim)
        if reconf:
            self.linear_obj = nn.Linear(3 * in_dim, out_dim)

    def forward(self, feat_cls: torch.Tensor, feat_reg: torch.Tensor,
                cls_score: torch.Tensor, fg_score: torch.Tensor,
                valid: torch.Tensor, lframe: int, sim_thresh: float = 0.75,
                use_mask: bool = False, conf_sim_thresh: float = 0.99):
        """feat_*: (F, P, C); scores/valid: (F, P); the first lframe
        frames are local. Returns (cls (lframe, P, out_dim), reg same or
        None)."""
        F_, P, C = feat_cls.shape

        def with_globals(t):
            g = t[lframe:].reshape(1, -1, *t.shape[2:])
            return torch.cat([t[:lframe], g.expand(lframe, *g.shape[1:])], 1)

        out_cls, out_reg = self.mca(
            with_globals(feat_cls), with_globals(feat_reg),
            with_globals(cls_score), with_globals(fg_score),
            with_globals(valid), P, sim_thresh=sim_thresh, use_mask=use_mask,
            conf_sim_thresh=conf_sim_thresh)
        out_reg = self.linear_obj(out_reg) if self.reconf else None
        return self.linear(out_cls), out_reg
