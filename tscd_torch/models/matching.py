"""CAFM matcher stack (counterpart of tscd_tpu/models/matching.py;
reference tscd_matching.py).

The temporal bank is an explicit `MatcherState` of device tensors,
carried from window to window; a fresh state (has_state False) is the
reference's sequence-start reset. Per local frame the matcher solves one
assignment on the card (`ops.hungarian`, the hand kernel) and keeps the
first-frame identity choice a device-side `where`, so the forward takes
no host sync.

LayerNorms use eps 1e-6 (flax's default, matching.py:140,205,280,290),
not torch's 1e-5, and `_l2norm` adds its eps 1e-6 to the norm
(matching.py:37), unlike aggregation's max(norm, 1e-12).

Compute dtype (`dtype`) as in the JAX modules: Linear layers, SE gates
and the carried bank run in it; LayerNorms keep fp32 parameters and run
in fp32 on the sum in the compute dtype, then cast back
(matching.py:140-141,205,258,280-291); attention logits, softmax and
`attn @ V` are fp32 (:110-120); vectors are normalised in their own
dtype and only the products accumulate in fp32, which for the match
cost is full fp32 (:163-176): the Hungarian decision sits on ~1e-3
margins.
"""

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..ops.hungarian import masked_linear_sum_assignment

NEG = -1e9
LN_EPS = 1e-6


def _norm(x: torch.Tensor) -> torch.Tensor:
    """`jnp.linalg.norm` over the last axis as XLA computes it under jit,
    returned in fp32: the squares summed in fp32, the sum and its root
    each rounded to x's dtype (no rounding at fp32)."""
    xf = x.float()
    s = (xf * xf).sum(-1, keepdim=True).to(x.dtype).float()
    return torch.sqrt(s).to(x.dtype).float()


def _l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x / (|x| + eps) over the last axis with the jitted JAX function's
    roundings: the denominator rounded to x's dtype, the quotient taken
    in fp32 and rounded once."""
    d = (_norm(x) + eps).to(x.dtype).float()
    return (x.float() / d).to(x.dtype)


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm of x in its parameters' dtype (fp32 in every model),
    cast back to x's dtype."""
    return norm(x.to(norm.weight.dtype)).to(x.dtype)


class SEGate(nn.Module):
    """SEModule (tscd_matching.py:264): per-(token, channel) 2-way gate
    fusing a content feature with its edge counterpart."""

    def __init__(self, hidden: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(2, hidden, bias=False, dtype=dtype),
                                nn.ReLU(),
                                nn.Linear(hidden, 2, bias=False, dtype=dtype))

    def forward(self, feat: torch.Tensor, edge: torch.Tensor) -> torch.Tensor:
        w = torch.sigmoid(self.fc(torch.stack([feat, edge], -1)))
        return feat * w[..., 0] + edge * w[..., 1]


def extract_position_matrix(bbox: torch.Tensor,
                            ref_bbox: torch.Tensor) -> torch.Tensor:
    """(N,4),(M,4) xyxy -> (N, M, 4) log-relative geometry
    (tscd_matching.py:1022)."""
    def parts(b):
        w = b[:, 2] - b[:, 0] + 1
        h = b[:, 3] - b[:, 1] + 1
        return w, h, 0.5 * (b[:, 0] + b[:, 2]), 0.5 * (b[:, 1] + b[:, 3])

    w_r, h_r, cx_r, cy_r = parts(ref_bbox)
    w, h, cx, cy = parts(bbox)
    dx = torch.log(torch.abs((cx[:, None] - cx_r[None, :]) / w[:, None]) + 1e-3)
    dy = torch.log(torch.abs((cy[:, None] - cy_r[None, :]) / h[:, None]) + 1e-3)
    dw = torch.log(w[:, None] / w_r[None, :])
    dh = torch.log(h[:, None] / h_r[None, :])
    return torch.stack([dx, dy, dw, dh], -1)


def extract_position_embedding(pos_mat: torch.Tensor, feat_dim: int = 64,
                               wave_length: float = 1000.0) -> torch.Tensor:
    """(N, M, 4) -> (N, M, feat_dim) sinusoidal (tscd_matching.py:998)."""
    rng = torch.arange(feat_dim // 8, dtype=torch.float32, device=pos_mat.device)
    dim_mat = wave_length ** ((8.0 / feat_dim) * rng)
    div = (pos_mat[..., None] * 100.0) / dim_mat
    emb = torch.cat([torch.sin(div), torch.cos(div)], -1)
    return emb.reshape(*pos_mat.shape[:2], -1)


class CosineMHAttention(nn.Module):
    """PositionMHAttention (tscd_matching.py:11): cosine-normalised QK,
    masked softmax, attn @ V. Leading batch axes are allowed.

    With `position_bias` the module holds the reference's
    `position_embedding`, a 1x1 conv of the 64-dim box-geometry embedding
    to one bias a head (its reference layout; JAX applies it as a Dense);
    a call with q_boxes/k_boxes (N, 4)/(M, 4) xyxy then adds log(ReLU(that
    bias) + 1e-6) to the SOFTMAXED attention before the value product, the
    reference's quirk that JAX keeps (matching.py:91,114-119). No caller of
    the TSCD head passes boxes, as in JAX, so its matcher has no such
    parameter."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 position_bias: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        kw = dict(bias=qkv_bias, dtype=dtype)
        self.q_reg = nn.Linear(dim, dim, **kw)
        self.k_reg = nn.Linear(dim, dim, **kw)
        self.v_reg = nn.Linear(dim, dim, **kw)
        if position_bias:
            self.position_embedding = nn.Conv2d(64, num_heads, 1, dtype=dtype)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        *lead, n, c = x.shape
        h = self.num_heads
        return x.reshape(*lead, n, h, c // h).transpose(-2, -3)

    def box_bias(self, q_boxes: torch.Tensor, k_boxes: torch.Tensor) -> torch.Tensor:
        """(h, N, M) log(ReLU(position_embedding(geometry)) + 1e-6) in fp32."""
        pe = extract_position_embedding(extract_position_matrix(q_boxes, k_boxes))
        conv = self.position_embedding
        w = conv.weight[:, :, 0, 0]
        bias = torch.relu(pe.to(w.dtype) @ w.T + conv.bias).permute(2, 0, 1)
        return torch.log(bias.float() + 1e-6)

    def forward(self, query, key, value, key_valid=None, q_boxes=None,
                k_boxes=None) -> torch.Tensor:
        f32 = torch.float32
        q = _l2norm(self._heads(self.q_reg(query))).to(f32)
        k = _l2norm(self._heads(self.k_reg(key))).to(f32)
        v = self._heads(self.v_reg(value)).to(f32)
        logits = torch.einsum("...hqd,...hkd->...hqk", q, k)
        if key_valid is not None:
            logits = logits + torch.where(key_valid[..., None, None, :],
                                          0.0, NEG).to(f32)
        attn = torch.softmax(logits, -1)
        if q_boxes is not None and k_boxes is not None:
            attn = self.box_bias(q_boxes, k_boxes) + attn
        out = torch.einsum("...hqk,...hkd->...hqd", attn, v)
        return out.transpose(-2, -3).reshape(query.shape).to(self.dtype)


class ReferringCrossAttention(nn.Module):
    """ReferringCrossAttentionLayer (tscd_matching.py:535), post-norm:
    LayerNorm(identify + attn(q=SE(tgt,q_edge)+q_pos,
                              k=SE(mem,edge)+pos, v=mem))."""

    def __init__(self, dim: int, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.CA = SEGate(dtype=dtype)
        self.multihead_attn = CosineMHAttention(dim, num_heads, dtype=dtype)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, identify, tgt, memory, pos, query_pos, edge,
                query_edge, key_valid=None):
        q = self.CA(tgt, query_edge) + query_pos
        k = self.CA(memory, edge) + pos
        out = self.multihead_attn(q, k, memory, key_valid)
        return _layer_norm(self.norm, identify + out)


class MatcherState(NamedTuple):
    """Device-resident temporal bank (reference last_* attrs, :708-715)."""
    out: torch.Tensor         # (P, C) last layer output, matched order
    reg_embeds: torch.Tensor  # (P, Cr) agg-enhanced reg embeds
    cls_embeds: torch.Tensor  # (P, Cr)
    edge: torch.Tensor        # (P, C)
    time: torch.Tensor        # (C,) projected time embedding
    valid: torch.Tensor       # (P,) bool
    has_state: torch.Tensor   # () bool


def init_matcher_state(p: int, c: int, cr: int, dtype=torch.float32,
                       device=None) -> MatcherState:
    def z(*s):
        return torch.zeros(s, dtype=dtype, device=device)
    return MatcherState(z(p, c), z(p, cr), z(p, cr), z(p, c), z(c),
                        torch.zeros(p, dtype=torch.bool, device=device),
                        torch.zeros((), dtype=torch.bool, device=device))


def dual_match_cost(prev_cls, cur_cls, prev_reg, cur_reg) -> torch.Tensor:
    """1 - mean cosine similarity over both branches
    (double_match_embds, tscd_matching.py:912). The embeddings are
    normalised in their own dtype, as in JAX (matching.py:163-176), and
    the products accumulate in full fp32 (exact for bf16 factors)."""
    f32 = torch.float32
    sim_cls = _l2norm(prev_cls).to(f32) @ _l2norm(cur_cls).to(f32).T
    sim_reg = _l2norm(prev_reg).to(f32) @ _l2norm(cur_reg).to(f32).T
    return torch.nan_to_num(1.0 - (sim_cls + sim_reg) / 2.0, nan=0.0)


class RegMatcher(nn.Module):
    """AwarePositionRegMatcher (tscd_matching.py:639) with explicit state.

    Per local frame: Hungarian-match previous<->current proposals on the
    dual cosine cost, permute current to matched order, run the referring
    cross-attention conditioned on time + edge features, unsort, update
    the bank."""

    def __init__(self, dim: int, num_heads: int = 8, num_layers: int = 1,
                 time_dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.absolute_position_embedding = nn.Linear(time_dim, dim, dtype=dtype)
        self.transformer_aware_cross_attention_layers = nn.ModuleList(
            ReferringCrossAttention(dim, num_heads, dtype)
            for _ in range(num_layers))
        self.decoder_norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, feats, reg_embeds, cls_embeds, edges, time_emb, valid,
                state: MatcherState) -> Tuple[torch.Tensor, MatcherState]:
        """feats/edges: (L, P, C); reg/cls_embeds: (L, P, Cr); time_emb:
        (L, 256) raw sinusoidal; valid: (L, P). Returns (outputs
        (L, P, C) in original order, new state)."""
        L, P, C = feats.shape
        time_proj = self.absolute_position_embedding(time_emb)
        ar = torch.arange(P, device=feats.device)
        outs = []
        for i in range(L):
            feat, reg_e, cls_e = feats[i], reg_embeds[i], cls_embeds[i]
            edge, t, vl = edges[i], time_proj[i], valid[i]
            st = state
            first = ~st.has_state
            # the solver reads a detached cost; the gathers by its
            # assignment stay differentiable, and the bank carries the
            # gradient from frame to frame, as JAX's scan does
            cost = dual_match_cost(st.cls_embeds, cls_e, st.reg_embeds, reg_e)
            perm = masked_linear_sum_assignment(cost.detach(), st.valid, vl).long()
            # sequence start: identity assignment (reference :788)
            perm = torch.where(first, ar, perm)
            m_feat, m_edge = feat[perm], edge[perm]
            # fresh rows self-reference (first frame, or a current proposal
            # assigned to an empty bank slot); live rows query the bank
            fresh = (first | ~st.valid)[:, None]
            tgt0 = torch.where(fresh, m_feat, st.out)
            prev_edge = torch.where(fresh, m_edge, st.edge)
            prev_time = torch.where(first, t, st.time)
            out = m_feat
            for li, layer in enumerate(self.transformer_aware_cross_attention_layers):
                layer_tgt = tgt0 if li == 0 else torch.where(first, out, tgt0)
                out = layer(out, layer_tgt, feat, pos=t[None, :],
                            query_pos=prev_time[None, :], edge=edge,
                            query_edge=prev_edge, key_valid=vl)
            outs.append(out[torch.argsort(perm)])
            state = MatcherState(out=out, reg_embeds=reg_e[perm],
                                 cls_embeds=cls_e[perm], edge=m_edge, time=t,
                                 valid=vl[perm],
                                 has_state=torch.ones_like(st.has_state))
        return _layer_norm(self.decoder_norm, torch.stack(outs, 0)), state


class _CrossAttentionLayer(nn.Module):
    """CrossAttentionLayer (tscd_matching.py:394), post-norm."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.multihead_attn = CosineMHAttention(dim, num_heads, dtype=dtype)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)


class TaskAligned(nn.Module):
    """TaskAligned (tscd_matching.py:1076): per-frame cross-attention
    aligning obj features to the matched reg features + final LayerNorm."""

    def __init__(self, dim: int, num_heads: int = 8, num_layers: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.transformer_cross_attention_layers = nn.ModuleList(
            _CrossAttentionLayer(dim, num_heads, dtype)
            for _ in range(num_layers))
        self.decoder_norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, feat_reg: torch.Tensor, feat_obj: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
        """feat_reg/feat_obj: (L, P, C); valid (L, P) -> (L, P, C)."""
        out = feat_obj
        for layer in self.transformer_cross_attention_layers:
            a = layer.multihead_attn(out, feat_reg, feat_reg, key_valid=valid)
            out = _layer_norm(layer.norm, out + a)
        return _layer_norm(self.decoder_norm, out)
