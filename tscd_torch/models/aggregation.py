"""Cross-frame attention aggregation (counterpart of
tscd_tpu/models/aggregation.py: DualBranchAttention, MCACore, MCAg2l,
MCAg2lAware, MSAYolov; reference post_trans.py:366,550,717,1109,1227).

MCA: each local frame's P proposals attend to its own frame plus every
global frame. The JAX package vmaps over local frames; here the local
frame is a batch axis written out. MSA (YOLOV): every proposal of the
window attends to every other, one batch of q = k = F x P rows, through
the joint q/k/v projections (`cross=False`); the online MSA
(`reg_score_guidance`) also weights the reg logits by the keys' fg score
(aggregation.py:68,125-126). The fused branch (no score-window mask) goes
through the hand kernel `ops.kernels.fused_attention`, the guidance too
(JAX computes that form outside Pallas, in XLA); the masked branch
(`use_mask`) is plain tensor code.

Compute dtype (`dtype`) as in the JAX modules: the Linear layers run in
it; logits, softmaxes and `attn @ V` are fp32 (the kernel upcasts bf16
q/k/v itself), and the outputs are cast back where JAX casts them
(aggregation.py:148-150,173-174). Vectors are L2-normalised in their
own dtype and only the products accumulate in fp32, as in JAX.
"""

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..ops.kernels.fused_attention import fused_dual_attention
from .matching import SEGate, _norm

NEG = -1e9


def _split_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    B, N, C = x.shape
    return x.reshape(B, N, h, C // h).transpose(1, 2)      # (B, h, N, d)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, h, N, d = x.shape
    return x.transpose(1, 2).reshape(B, N, h * d)


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # eps 1e-12 under a max, as aggregation.py:42 (the matcher's differs);
    # the jitted JAX function's roundings, as matching._l2norm
    return (x.float() / _norm(x).clamp(min=eps)).to(x.dtype)


class AttnPieces(NamedTuple):
    out_cls: torch.Tensor     # (B, q, 2C) [attn V_cls | V_cls[:q]]
    out_reg: torch.Tensor     # (B, q, 2C)
    sim_round2: torch.Tensor  # (B, q, k) normalised cls similarity weights
    obj_round2: torch.Tensor  # (B, q, k) normalised reg similarity weights
    v_cls: torch.Tensor       # (B, k, C) merged value features
    v_reg: torch.Tensor       # (B, k, C)


class DualBranchAttention(nn.Module):
    """Shared attention core. `cross=True` (Attention_mca_g2l): q from
    the first n_query tokens through q_cls_local / q_reg_local, k/v over
    all tokens through kv_cls / kv_reg. `cross=False` (Attention_msa):
    the joint projections qkv_cls / qkv_reg, split into q, k and v in
    that order, q the first n_query rows (aggregation.py:82-91).
    `reg_score_guidance` (Attention_msa_online, post_trans.py:950): the
    reg logits times each key's fg score, where one is passed."""

    def __init__(self, dim: int, num_heads: int = 4, scale: float = 25.0,
                 qkv_bias: bool = False, dtype: torch.dtype = torch.float32,
                 cross: bool = True, reg_score_guidance: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.scale = scale
        self.dtype = dtype
        self.cross = cross
        self.reg_score_guidance = reg_score_guidance
        kw = dict(bias=qkv_bias, dtype=dtype)
        if cross:
            self.q_cls_local = nn.Linear(dim, dim, **kw)
            self.kv_cls = nn.Linear(dim, 2 * dim, **kw)
            self.q_reg_local = nn.Linear(dim, dim, **kw)
            self.kv_reg = nn.Linear(dim, 2 * dim, **kw)
        else:
            self.qkv_cls = nn.Linear(dim, 3 * dim, **kw)
            self.qkv_reg = nn.Linear(dim, 3 * dim, **kw)

    def project(self, x_cls: torch.Tensor, x_reg: torch.Tensor, n_query: int):
        """q, k, v of both branches (B, h, rows, d), q of the first
        n_query tokens."""
        h = self.num_heads
        if self.cross:
            k_cls, v_cls = self.kv_cls(x_cls).chunk(2, -1)
            k_reg, v_reg = self.kv_reg(x_reg).chunk(2, -1)
            q_cls = self.q_cls_local(x_cls[:, :n_query])
            q_reg = self.q_reg_local(x_reg[:, :n_query])
        else:
            q_cls, k_cls, v_cls = self.qkv_cls(x_cls).chunk(3, -1)
            q_reg, k_reg, v_reg = self.qkv_reg(x_reg).chunk(3, -1)
            q_cls, q_reg = q_cls[:, :n_query], q_reg[:, :n_query]
        return tuple(_split_heads(t, h) for t in (q_cls, k_cls, v_cls, q_reg, k_reg, v_reg))

    def attend(self, x_cls: torch.Tensor, x_reg: torch.Tensor,
               cls_score: Optional[torch.Tensor],
               fg_score: Optional[torch.Tensor], key_valid: torch.Tensor,
               n_query: int, sim_thresh: float = 0.75,
               use_mask: bool = False, conf_sim_thresh: float = 0.99
               ) -> AttnPieces:
        """x_*: (B, N, C); cls_score/fg_score/key_valid: (B, N)."""
        h = self.num_heads
        f32 = torch.float32
        qc0, kc0, vc, qr0, kr0, vr = self.project(x_cls, x_reg, n_query)
        vcn, vrn = _l2norm(vc), _l2norm(vr)
        kv = key_valid[:, None, :]

        cls_mask = None
        fg = fg_score if self.reg_score_guidance else None
        if not use_mask:
            score = (cls_score.to(f32) if cls_score is not None
                     else torch.ones_like(key_valid, dtype=f32))
            x, xr, attn = fused_dual_attention(qc0, kc0, vc, qr0, kr0, vr,
                                               score, key_valid, self.scale, fg)
        else:
            qc, kc, qr, kr = (_l2norm(t).to(f32) for t in (qc0, kc0, qr0, kr0))
            logits_cls = torch.einsum("bhqd,bhkd->bhqk", qc, kc) * self.scale
            logits_reg = torch.einsum("bhqd,bhkd->bhqk", qr, kr) * self.scale
            if cls_score is not None:
                logits_cls = logits_cls * cls_score.to(f32)[:, None, None, :]
            if fg is not None:
                logits_reg = logits_reg * fg.to(f32)[:, None, None, :]
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

        dt = self.dtype
        out_cls = torch.cat([_merge_heads(x), _merge_heads(vc[:, :, :n_query]).to(f32)],
                            -1).to(dt)
        out_reg = torch.cat([_merge_heads(xr), _merge_heads(vr[:, :, :n_query]).to(f32)],
                            -1).to(dt)

        # round-2 similarity masks (post_trans.py:803-824)
        vcn, vrn = vcn.to(f32), vrn.to(f32)
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
        return AttnPieces(out_cls, out_reg, sim_round2.to(dt), obj_round2.to(dt),
                          _merge_heads(vc), _merge_heads(vr))


class MCACore(DualBranchAttention):
    """Attention_mca_g2l (post_trans.py:550): attention core + 2C->2C
    linear(s), then with `ave` (the mode the TSCD exps run,
    tscd_base.py:58) the round-2 pooling of raw V -> (B, q, 3C); without
    it the linear outputs (B, q, 2C) (aggregation.py:203-204). Subclasses
    the core so the parameter names stay flat (`mca.q_cls_local`,
    `mca.linear`) as in the reference."""

    def __init__(self, dim: int, num_heads: int = 4, scale: float = 25.0,
                 reconf: bool = False, ave: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dim, num_heads, scale, dtype=dtype)
        self.reconf = reconf
        self.ave = ave
        self.linear = nn.Linear(2 * dim, 2 * dim, dtype=dtype)
        if reconf:
            self.linear_reg = nn.Linear(2 * dim, 2 * dim, dtype=dtype)

    def forward(self, x_cls, x_reg, cls_score, fg_score, key_valid, n_query,
                sim_thresh=0.75, use_mask=False, conf_sim_thresh=0.99
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        p = self.attend(x_cls, x_reg, cls_score, fg_score, key_valid,
                        n_query, sim_thresh=sim_thresh, use_mask=use_mask,
                        conf_sim_thresh=conf_sim_thresh)
        out_cls = self.linear(p.out_cls)
        out_reg = self.linear_reg(p.out_reg) if self.reconf else None
        if not self.ave:
            return out_cls, out_reg
        cls_feature = torch.cat([p.sim_round2 @ p.v_cls, out_cls], -1)
        reg_feature = (torch.cat([p.obj_round2 @ p.v_reg, out_reg], -1)
                       if self.reconf else None)
        return cls_feature, reg_feature


class MCAg2l(nn.Module):
    """MCA_tscd_g2l_reg (post_trans.py:1109): local-frame proposals
    attend to own frame + all global frames. `ave` as `MCACore`'s: the
    output Linear layers take 3C with it, 2C without."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int = 4,
                 scale: float = 25.0, reconf: bool = False, ave: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.reconf = reconf
        self.mca = MCACore(in_dim, num_heads, scale, reconf, ave, dtype)
        width = (3 if ave else 2) * in_dim
        self.linear = nn.Linear(width, out_dim, dtype=dtype)
        if reconf:
            self.linear_obj = nn.Linear(width, out_dim, dtype=dtype)

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


class MCAg2lAware(nn.Module):
    """Edge-aware MCA (Attention_mca_aware_g2l, post_trans.py:366 +
    MCA_tscd_aware_g2l_{cls,reg}:1071,1165; aggregation.py:268-292): the
    reg features SE-gated with the wavelet edge features of the same
    proposals, then `MCAg2l` (the hand attention kernel on its fused
    branch). Parameters `se.*` and `mca.*`, as JAX's `agg/se`,
    `agg/mca/mca/attn`."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int = 4,
                 scale: float = 25.0, reconf: bool = False, ave: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.se = SEGate(dtype=dtype)
        self.mca = MCAg2l(in_dim, out_dim, num_heads, scale, reconf, ave, dtype)

    def forward(self, feat_cls: torch.Tensor, feat_reg: torch.Tensor,
                edge: torch.Tensor, cls_score: torch.Tensor,
                fg_score: torch.Tensor, valid: torch.Tensor, lframe: int,
                **kw):
        """As `MCAg2l.forward`, with `edge` (F, P, C) the edge features of
        every frame's proposals."""
        return self.mca(feat_cls, self.se(feat_reg, edge), cls_score,
                        fg_score, valid, lframe, **kw)


class MSAYolov(nn.Module):
    """MSA_yolov (post_trans.py:1227; aggregation.py:295-335): the joint
    self-attention over every proposal of the window (one batch, q = k =
    N), linear1 (2C -> 2C), round 2 pooling the projected features
    (sim_round2 @ linear1) -> 4C -> linear2 to out_dim; with `reconf` the
    same on the reg branch (linear1_obj, linear2_obj, obj_round2).
    Parameters `msa.qkv_cls`, `linear1`, ... as the reference's.
    `reg_score_guidance` (the online head's MSA, MSA_yolov_online): the
    reg logits times the keys' fg score."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int = 4,
                 scale: float = 25.0, reconf: bool = False,
                 dtype: torch.dtype = torch.float32, reg_score_guidance: bool = False):
        super().__init__()
        self.reconf = reconf
        self.msa = DualBranchAttention(in_dim, num_heads, scale, dtype=dtype, cross=False,
                                       reg_score_guidance=reg_score_guidance)
        self.linear1 = nn.Linear(2 * in_dim, 2 * in_dim, dtype=dtype)
        self.linear2 = nn.Linear(4 * in_dim, out_dim, dtype=dtype)
        if reconf:
            self.linear1_obj = nn.Linear(2 * in_dim, 2 * in_dim, dtype=dtype)
            self.linear2_obj = nn.Linear(4 * in_dim, out_dim, dtype=dtype)

    def forward(self, feat_cls: torch.Tensor, feat_reg: torch.Tensor,
                cls_score: torch.Tensor, fg_score: torch.Tensor,
                valid: torch.Tensor, sim_thresh: float = 0.75,
                conf_sim_thresh: float = 0.99,
                obj: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """feat_* (N, C) flattened across frames; scores and valid (N,).
        Returns (cls (N, out_dim), obj (N, out_dim) or None); `obj` False
        skips the reg branch's pooling where the caller drops it."""
        N = feat_cls.shape[0]
        p = self.msa.attend(feat_cls[None], feat_reg[None], cls_score[None],
                            fg_score[None], valid[None], N, sim_thresh=sim_thresh,
                            conf_sim_thresh=conf_sim_thresh)
        lin1 = self.linear1(p.out_cls[0])
        out = self.linear2(torch.cat([p.sim_round2[0] @ lin1, lin1], -1))
        if not (self.reconf and obj):
            return out, None
        lin1_obj = self.linear1_obj(p.out_reg[0])
        return out, self.linear2_obj(torch.cat([p.obj_round2[0] @ lin1_obj, lin1_obj], -1))
