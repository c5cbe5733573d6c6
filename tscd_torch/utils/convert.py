"""Weights carried across: JAX/flax variables and reference `.pth` files
into the port.

The port's parameter names are the reference's torch `state_dict` names,
so a reference `.pth` loads as it is (`load_reference_pth`). For flax
variables, `state_dict_from_flax` maps each key of the port's state_dict
to its flax path with this module's copy of the name rules of
tscd_tpu/utils/convert.py (torch_to_flax), then changes the layout:
HWIO kernel -> OIHW conv weight, (in, out) kernel -> (out, in) linear
weight (or (out, in, 1, 1) for the reference's 1x1 conv that JAX runs as
a Dense), BN scale/bias/mean/var -> weight/bias/running_mean/running_var,
LayerNorm scale -> weight. `flax_from_state_dict` is the inverse.

The YOLOV family's heads hold their stems, towers and per-level preds
under JAX's `towers` module (yolov_heads.py:_VideoTowers), where TSCD
and YOLOX hold them on the head itself. The names do not say which:
a state_dict whose head has a video cls tower and no edge block
(`yolov_towers`) is a YOLOV family model's, and its tower names map
under `head/towers`. The online head's MSA sits under `head/trans`
(`head.trans.msa.qkv_cls`, `head.trans.linear1`, ...) in both, as its
`cls_pred` on the head: the same rules carry JAX's YOLOVOnline
variables.

A Swin, FocalNet or ResNet pyramid (`models.pafpn_variants`) keeps the
reference's names: its network under the wrapper's `backbone`, named as
the reference modules name their parameters, and the neck's convs on
the wrapper itself (`backbone.lateral_conv0` in a TSCD model). JAX
names the network's modules its own way (`layer0_block1`, `merge0`,
`focal_conv_2`, `layer1_0/downsample/conv`; the rules are this module's
copy of tscd_tpu/utils/convert.py:backbone_to_flax's) and holds the neck
under `neck`. `backbone_layout` finds such a network in a state_dict's
names. JAX sizes a Swin block's relative-position table by its window,
(2 ws - 1)^2 rows, and its window shrinks on maps under 7 px (frames
under 224 px), so JAX's tree depends on the frame size it was built at;
the port's table is the reference's full one at every size, and a
smaller JAX table is its central block (`swin.relative_position_index`).
`state_dict_from_flax` writes a smaller table there, with a warning: the
rows outside it keep the port model's own values, and a frame large
enough to read them (a window JAX's tree was not built for) reads
those. `flax_from_state_dict(..., frame_size=)` cuts each table to the
window JAX builds at that frame size. The buffers JAX recomputes
(`relative_position_index`, `attn_mask`) have no flax path: a reference
`.pth` loads with them as skipped keys (`tools.tscd_eval.load_weights`).

The YOLOv7 ELAN modules keep the reference's names too (`ELANNet.py`:
`stem.{i}` or the Focus `stem.conv`, `blocks.{i}.{j}`, `bottlenecks.{i}`,
`rbr_dense.0/1`, `rbr_identity`, `repconvs.{i}`), mapped as JAX's reader
maps them (this module's copy of tscd_tpu/utils/convert.py:293-373;
`elan_layout` finds the network and the neck, and whether the network is
tiny's, whose later stages start with a paramless max-pool). YOLOv8's
names are JAX's own and go through the rules above unchanged. The DETR
decoder's attention projections are nn.Linear in the port and flax
DenseGeneral kernels (dim, heads, head_dim) and (heads, head_dim, dim) in
JAX: `state_dict_from_flax` reshapes them by the template's shapes,
`flax_from_state_dict` needs the head count (`heads`).
"""

import re
import warnings
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch


def _translate_backbone(parts):
    """Translate CSPDarknet/PAFPN segment names."""
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p in ("dark2", "dark3", "dark4", "dark5"):
            idx = parts[i + 1]
            if p == "dark5":
                sub = {"0": "conv", "1": "spp", "2": "csp"}[idx]
            else:
                sub = {"0": "conv", "1": "csp"}[idx]
            out.append(f"{p}_{sub}")
            i += 2
        elif p == "m" and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"m_{parts[i + 1]}")
            i += 2
        else:
            out.append(p)
            i += 1
    return out


def _translate_head(parts):
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p in ("stems", "cls_preds", "reg_preds", "obj_preds"):
            k = parts[i + 1]
            base = {"stems": "stem", "cls_preds": "cls_pred",
                    "reg_preds": "reg_pred", "obj_preds": "obj_pred"}[p]
            out.append(f"{base}_{k}")
            i += 2
        elif p in ("cls_convs", "reg_convs", "cls_convs2", "reg_convs2"):
            k, j = parts[i + 1], parts[i + 2]
            base = {"cls_convs": "cls_conv", "reg_convs": "reg_conv",
                    "cls_convs2": "cls_conv2",
                    "reg_convs2": "reg_conv2"}[p]
            out.append(f"{base}_{k}_{j}")
            i += 3
        elif p == "edge_enhance_reg":
            k = parts[i + 1]
            out.append(f"edge_{k}")
            # skip the Sequential index (always 0)
            i += 3 if i + 2 < len(parts) and parts[i + 2] == "0" else 2
        elif p == "filter1" or p == "filter2":
            out.append(p)
            # skip Sequential conv index
            if i + 1 < len(parts) and parts[i + 1] == "0":
                i += 2
            else:
                i += 1
        else:
            out.append(p)
            i += 1
    return out


_QKV_NAMES = ("q_cls_local", "kv_cls", "q_reg_local", "kv_reg")
# flax MultiHeadDotProductAttention's projections (the DETR decoder's)
_MHA_PROJ = ("query", "key", "value", "out")


def _translate_video(parts):
    """Translate TSCD video-stack segment names (aggregation + matcher +
    task-aligned), for the modules the port has."""
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p == "mca" and i + 1 < len(parts) and parts[i + 1] in _QKV_NAMES:
            # the projections live on the flax DualBranchAttention 'attn'
            out.extend(["mca", "attn"])
            i += 1
        elif p == "transformer_aware_cross_attention_layers":
            out.append(f"layer_{parts[i + 1]}")
            i += 2
        elif p == "transformer_cross_attention_layers":
            # TaskAligned: layer j -> attn_j / norm_j
            j = parts[i + 1]
            rest = parts[i + 2:]
            if rest and rest[0] == "multihead_attn":
                out.append(f"attn_{j}")
                i += 3
            elif rest and rest[0] == "norm":
                out.append(f"norm_{j}")
                i += 3
            else:
                out.append(f"layer_{j}")
                i += 2
        elif p in ("multihead_attn", "self_attn") and not (
                i + 1 < len(parts) and parts[i + 1] in _MHA_PROJ):
            out.append("attn")
            i += 1
        elif p == "transBlocks":
            # LocalAggregation's blocks (post_trans.py:972)
            out.append(f"block_{parts[i + 1]}")
            i += 2
        elif p == "net" and i + 1 < len(parts) and parts[i + 1] in ("0", "3"):
            # FFN Sequential(Linear, GELU, Dropout, Linear, Dropout) -> fc1/fc2
            out.append("fc1" if parts[i + 1] == "0" else "fc2")
            i += 2
        elif p == "fc" and i + 1 < len(parts) and parts[i + 1] in ("0", "2"):
            # SEModule Sequential(Linear, ReLU, Linear) -> fc1/fc2
            out.append("fc1" if parts[i + 1] == "0" else "fc2")
            i += 2
        else:
            out.append(p)
            i += 1
    return out


_TOWER_PREFIXES = ("stem_", "cls_conv_", "reg_conv_", "cls_conv2_", "reg_conv2_",
                   "cls_pred_", "reg_pred_", "obj_pred_")


def yolov_towers(names: Iterable[str]) -> Optional[str]:
    """The head's prefix ("head." in a model, "" in a bare head) where the
    state_dict names are a YOLOV family head's: a video cls tower
    (`cls_convs2`) and no edge block, which every TSCD head has (and
    YOLOX has neither); else None."""
    names = list(names)
    for pre in ("head.", ""):
        if (any(n.startswith(pre + "cls_convs2.") for n in names)
                and not any(n.startswith(pre + "edge_enhance_reg.") for n in names)):
            return pre
    return None


# -- the other backbones' networks (tscd_tpu/utils/convert.py:221-290) --
def _stage_parts(p: List[str], block, down) -> Optional[List[str]]:
    """A Swin or FocalNet name's parts (no leaf) -> JAX's module path, None
    to drop: the stem, the output norms and each block's norms and MLP by
    the rules the two share; `block(base, rest)` maps the rest of a
    block's parts, `down(stage, part)` a stage's downsample."""
    if p[0] == "patch_embed":
        return ["patch_embed"] if p[1] == "proj" else ["patch_norm"]
    if p[0].startswith("norm") and p[0][4:].isdigit():
        return [f"out_norm{p[0][4:]}"]
    if p[0] != "layers":
        return None
    stage = int(p[1])
    if p[2] == "downsample":
        return down(stage, p[3])
    if p[2] != "blocks":
        return None
    base, rest = [f"layer{stage}_block{int(p[3])}"], p[4:]
    if rest and rest[0] in ("norm1", "norm2"):
        return base + [rest[0]]
    if rest and rest[0] == "mlp":
        return base + [f"mlp_{rest[1]}"]
    return block(base, rest)


def _swin_block(base: List[str], rest: List[str]) -> Optional[List[str]]:
    return base + rest if rest and rest[0] == "attn" else None


def _focalnet_block(base: List[str], rest: List[str]) -> Optional[List[str]]:
    if not rest:                                 # gamma_1 / gamma_2
        return base
    if rest[0] != "modulation":
        return None
    if len(rest) > 1 and rest[1] == "focal_layers":
        return base + ["modulation", f"focal_conv_{int(rest[2])}"]
    return base + rest


def _swin_parts(p: List[str]) -> Optional[List[str]]:
    return _stage_parts(p, _swin_block, lambda i, part: [
        f"merge{i}", "norm" if part == "norm" else "reduction"])


def _focalnet_parts(p: List[str]) -> Optional[List[str]]:
    return _stage_parts(p, _focalnet_block, lambda i, part: [
        f"down{i}" if part == "proj" else f"down_norm{i}"])


def _resnet_parts(p: List[str]) -> Optional[List[str]]:
    if p[0] == "stem":
        return ["stem"] + p[1:]
    m = re.fullmatch(r"layer(\d+)", p[0])
    if not m:
        return None
    base, rest = [f"layer{m.group(1)}_{int(p[1])}"], p[2:]
    if rest[0] == "downsample":
        return base + ["downsample", "conv" if rest[1] == "0" else "bn"]
    return base + rest


def _elan_inner(rest: List[str]) -> List[str]:
    """An ELAN module's inner names: `bottlenecks.{i}` -> bottleneck_{i};
    RepConv's Sequential(conv, bn) -> the conv on its name, the BN on
    <name>_bn; `rbr_identity` -> rbr_identity_bn; the paramless pools go."""
    out, i = [], 0
    while i < len(rest):
        r = rest[i]
        if r == "bottlenecks":
            out.append(f"bottleneck_{int(rest[i + 1])}")
            i += 2
        elif r in ("rbr_dense", "rbr_1x1"):
            out.append(r if rest[i + 1] == "0" else f"{r}_bn")
            i += 2
        elif r == "rbr_identity":
            out.append("rbr_identity_bn")
            i += 1
        elif r in ("maxpool", "mp"):
            i += 1
        else:
            out.append(r)
            i += 1
    return out


def _elan_parts(tiny: bool):
    """An ELANNet's or ELAN neck's name parts -> JAX's module path (None
    for a paramless max-pool): `stem.{i}` -> stem_{i}, the Focus
    `stem.conv` -> stem/conv, `blocks.{i}.{j}` -> stage{i}_down / _elan /
    _spp (tiny: no stage-0 downsample, later stages' j = 0 a max-pool),
    `repconvs.{i}` -> repconv_{i}, the neck's names as they are."""
    def parts(p: List[str]) -> Optional[List[str]]:
        if p[0] == "stem":
            if p[1] == "conv":
                return ["stem", "conv"] + _elan_inner(p[2:])
            return [f"stem_{int(p[1])}"] + _elan_inner(p[2:])
        if p[0] == "blocks":
            i, j = int(p[1]), int(p[2])
            kinds = ((["elan"] if i == 0 else ["mp", "elan"]) if tiny else ["down", "elan"])
            kind = (kinds + ["spp"])[j]
            return None if kind == "mp" else [f"stage{i}_{kind}"] + _elan_inner(p[3:])
        if p[0] == "repconvs":
            return [f"repconv_{int(p[1])}"] + _elan_inner(p[2:])
        return [p[0]] + _elan_inner(p[1:])
    return parts


ELAN_ARCHS = ("tiny", "L", "X", "W6", "E6", "D6", "E6E")
BACKBONE_PARTS = {"swin": _swin_parts, "focalnet": _focalnet_parts, "resnet": _resnet_parts,
                  **{f"elan-{a}": _elan_parts(a == "tiny") for a in ELAN_ARCHS}}
# a reference Swin's buffers that JAX recomputes (as the port does)
RECOMPUTED = ("relative_position_index", "attn_mask")
_NETWORKS = ((re.compile(r"^(.*?)layers\.\d+\.blocks\.\d+\.attn\."), "swin"),
             (re.compile(r"^(.*?)layers\.\d+\.blocks\.\d+\.modulation\."), "focalnet"),
             (re.compile(r"^(.*?)layer1\.0\.ConvBn1\."), "resnet"))


def backbone_layout(names: Iterable[str]) -> Optional[Tuple[str, str]]:
    """(the network's name prefix, its family) where the names hold a
    Swin, FocalNet or ResNet network at the top ("") or under a
    `backbone` ("backbone.backbone." in a model, "backbone." in a bare
    pyramid); else None."""
    for n in names:
        for rx, family in _NETWORKS:
            m = rx.match(n)
            if m and (m.group(1) == "" or m.group(1).endswith("backbone.")):
                return m.group(1), family
    return None


def elan_layout(names: Iterable[str]) -> Optional[Tuple[Tuple[str, ...], bool]]:
    """(the name prefixes of an ELAN network and neck, whether the network
    is tiny's) where the names hold an ELANNet (`stem.` and `blocks.` at
    the top or under a `backbone.`) or an ELAN neck (`lateral_conv1.` and
    `route_conv1.`); else None."""
    names = list(names)
    starts = lambda pre: any(n.startswith(pre) for n in names)   # noqa: E731
    nets = {n[:n.index("blocks.")] for n in names if "blocks." in n}
    nets = [p for p in nets if (p == "" or p.endswith("backbone.")) and starts(p + "stem.")
            and not starts(p + "layers.")]
    necks = {n[:n.index("route_conv1.")] for n in names if "route_conv1." in n}
    necks = [p for p in necks if starts(p + "lateral_conv1.")]
    if not nets and not necks:
        return None
    return tuple(nets + necks), any(starts(p + "blocks.0.0.conv1.") for p in nets)


def backbone_to_flax(state: Mapping[str, Any], family: str) -> Dict[str, Dict]:
    """A reference network's state_dict (tensors or arrays; e.g. an official
    Swin checkpoint, or an ELANNet's or ELAN neck's with family
    `elan-<arch>`) -> {'params', 'batch_stats'} of numpy arrays in JAX's
    layout for its tscd_tpu module; names without a flax path (the buffers
    JAX recomputes, a classifier) are left out."""
    return flax_from_state_dict({n: torch.as_tensor(np.asarray(t)) for n, t in state.items()
                                 if flax_module_path(n, backbone=("", family)) is not None})


def _table_slice(big: int, small: int):
    """The rows of a (2 big - 1)^2 relative-position table that a table of
    (2 small - 1)^2 rows holds, in its order (`relative_position_index`)."""
    side, s = 2 * big - 1, 2 * small - 1
    off = big - small
    return (np.arange(s)[:, None] + off) * side + (np.arange(s)[None, :] + off)


def _side(rows: int) -> int:
    return (int(round(rows ** 0.5)) + 1) // 2


def _jax_table_side(name: str, rows: int, frame_size: Tuple[int, int]) -> int:
    """The window of the Swin table `name` (`...layers.{i}.blocks...`,
    `rows` the full table's rows) in JAX's tree built at `frame_size`:
    min(window, stage i's map), the map H // 4 after the patch embed and
    halved, rounding up, at each merge (tscd_tpu/models/swin.py:110,
    :150)."""
    stage = int(name.split(".")[name.split(".").index("layers") + 1])
    h, w = frame_size[0] // 4, frame_size[1] // 4
    for _ in range(stage):
        h, w = (h + 1) // 2, (w + 1) // 2
    return min(_side(rows), h, w)


def flax_module_path(name: str, towers: Optional[str] = None,
                     backbone: Optional[Tuple[str, str]] = None,
                     elan: Optional[Tuple[Tuple[str, ...], bool]] = None
                     ) -> Optional[Tuple[str, ...]]:
    """Port / reference parameter name without its leaf -> flax module
    path, e.g. 'head.agg.mca.kv_cls.weight' -> ('head', 'agg', 'mca',
    'attn', 'kv_cls'); with `towers` the prefix of a YOLOV family head
    (`yolov_towers`), its stems, towers and preds go under 'towers'; with
    `backbone` (`backbone_layout`) the network's names map by its family's
    rules and the neck's go under 'neck'; with `elan` (`elan_layout`) the
    ELAN network's and neck's names map by JAX's ELAN rules. None for a
    name with no flax path (a buffer JAX recomputes, a paramless pool)."""
    parts = name.split(".")[:-1]
    if elan is not None:
        prefixes, tiny = elan
        for pre in prefixes:
            if name.startswith(pre):
                k = len(pre.split(".")) - 1
                sub = _elan_parts(tiny)(parts[k:])
                return None if sub is None else tuple(parts[:k]) + tuple(sub)
    if backbone is not None:
        net, family = backbone
        k = len(net.split(".")) - 1
        if name.startswith(net):
            sub = BACKBONE_PARTS[family](parts[k:])
            if sub is None or name.split(".")[-1] in RECOMPUTED:
                return None
            return tuple(parts[:k]) + tuple(sub)
        wrapper = net[:-len("backbone.")] if net else None
        if wrapper is not None and name.startswith(wrapper):
            k -= 1
            return tuple(parts[:k]) + ("neck",) + tuple(_translate_backbone(parts[k:]))
    path = tuple(_translate_video(_translate_head(_translate_backbone(parts))))
    if towers is not None and name.startswith(towers):
        i = len(towers.split(".")) - 1
        if len(path) > i and path[i].startswith(_TOWER_PREFIXES):
            path = path[:i] + ("towers",) + path[i:]
    return path


# 1x1 convs of the reference that JAX applies as a Dense on the last axis
# (PositionMHAttention.position_embedding, tscd_matching.py:27;
# SelfAttentionLocal.loc2feature over the 64-dim relation embedding,
# post_trans.py:86; tscd_tpu/utils/convert.py:168-175): a 4-d weight there
_DENSE_AS_CONV = ("position_embedding", "loc2feature")

_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}


def _is_bn(path: Optional[Tuple[str, ...]]) -> bool:
    """A BatchNorm's flax module path: `bn`, or RepConv's `<branch>_bn`."""
    return bool(path) and (path[-1] == "bn" or path[-1].endswith("_bn"))


def flax_param_path(name: str, ndim: int, towers: Optional[str] = None,
                    backbone: Optional[Tuple[str, str]] = None,
                    elan: Optional[Tuple[Tuple[str, ...], bool]] = None) -> Tuple[str, ...]:
    """A port parameter's flax `params` path, leaf included: the module
    path of `flax_module_path` and the leaf flax names it by (`kernel` for
    a conv or Linear weight of `ndim` 4 or 2, `scale` for a BatchNorm or
    LayerNorm weight)."""
    path = flax_module_path(name, towers, backbone, elan)
    leaf = name.split(".")[-1]
    if _is_bn(path):
        return path + (_BN_LEAVES[leaf][1],)
    if leaf == "weight":
        return path + (("kernel",) if ndim in (2, 4) else ("scale",))
    return path + (leaf,)


def flatten_tree(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    """{path tuple: leaf} of a nested dict (empty dicts give no leaf)."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def state_dict_from_flax(variables: Mapping[str, Mapping],
                         template: Mapping[str, torch.Tensor],
                         strict: bool = True) -> Dict[str, torch.Tensor]:
    """JAX {'params', 'batch_stats'} tree (numpy arrays) -> the port's
    state_dict. `template` is the port model's own state_dict: it gives
    the keys, shapes and dtypes; num_batches_tracked is kept from it. With
    `strict` False a key the tree lacks, or holds at another shape, is left
    out (for a shape-tolerant load) instead of raising."""
    coll = {c: flatten_tree(variables.get(c, {})) for c in ("params", "batch_stats")}
    towers, bb, elan = yolov_towers(template), backbone_layout(template), elan_layout(template)
    out: Dict[str, torch.Tensor] = {}
    shrunk: List[str] = []
    for name, ref in template.items():
        leaf = name.split(".")[-1]
        if leaf == "num_batches_tracked":
            out[name] = ref.clone()
            continue
        path = flax_module_path(name, towers, bb, elan)
        if _is_bn(path):
            c, key = _BN_LEAVES[leaf]
        elif leaf == "weight":
            c, key = "params", ("kernel" if ref.dim() in (2, 4) else "scale")
        else:
            c, key = "params", leaf
        if not strict and path + (key,) not in coll[c]:
            continue
        arr = np.asarray(coll[c][path + (key,)])
        if leaf == "weight" and path and path[-1] in _DENSE_AS_CONV and ref.dim() == 4:
            arr = arr.T[:, :, None, None]               # (in,out) -> (out,in,1,1)
        elif leaf == "weight" and ref.dim() == 4:       # HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        elif leaf == "weight" and ref.dim() == 2:       # (in,out) -> (out,in)
            arr = _mha_kernel(arr, path).T
        elif leaf == "bias" and arr.ndim == 2 and ref.dim() == 1:   # (heads, head_dim)
            arr = arr.reshape(-1)
        elif leaf == "relative_position_bias_table" and arr.shape != tuple(ref.shape):
            k = _side(arr.shape[0])                             # a shrunk window's table
            full = ref.detach().cpu().float().numpy().copy()
            full[_table_slice(_side(full.shape[0]), k).reshape(-1)] = arr
            arr = full
            shrunk.append(f"{name} ({k} x {k})")
        t = torch.from_numpy(np.array(arr, copy=True)).to(ref.dtype)
        if t.shape != ref.shape:
            if not strict:
                continue
            raise ValueError(f"{name}: flax {tuple(t.shape)} != port "
                             f"{tuple(ref.shape)}")
        out[name] = t
    if shrunk:
        warnings.warn(f"{len(shrunk)} Swin tables JAX built for shrunk windows, e.g. "
                      f"{shrunk[-1]}: the rows of larger windows keep the model's own values")
    return out


def _mha_kernel(arr: np.ndarray, path: Tuple[str, ...]) -> np.ndarray:
    """A flax attention projection's kernel as a 2-d (in, out) matrix:
    query/key/value (dim, heads, head_dim) -> (dim, heads head_dim), out
    (heads, head_dim, dim) -> (heads head_dim, dim); others as they are."""
    if arr.ndim != 3:
        return arr
    return arr.reshape(-1, arr.shape[-1]) if path[-1] == "out" else arr.reshape(arr.shape[0], -1)


def flax_from_state_dict(state: Mapping[str, torch.Tensor],
                         frame_size: Optional[Tuple[int, int]] = None,
                         heads: Optional[int] = None) -> Dict[str, Dict]:
    """The port's state_dict -> a JAX {'params', 'batch_stats'} tree of
    numpy arrays in flax's layout (the inverse of `state_dict_from_flax`;
    num_batches_tracked has no flax counterpart and is left out). Each
    value keeps its dtype; a bfloat16 one stays a torch tensor, which
    `utils.flax_msgpack` writes as flax's bfloat16 ndarray. With
    `frame_size` (H, W), each Swin table is cut to the window JAX's tree
    built at that frame size holds (`_jax_table_side`; the whole table at
    224 px and more). The DETR decoder's attention projections (`...attn.
    query.weight`) go to flax's DenseGeneral layout, which takes their
    head count `heads`."""
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    towers, bb, elan = yolov_towers(state), backbone_layout(state), elan_layout(state)
    for name, t in state.items():
        leaf = name.split(".")[-1]
        if leaf == "num_batches_tracked":
            continue
        path = flax_module_path(name, towers, bb, elan)
        if path is None:
            continue
        if _is_bn(path):
            c, key = _BN_LEAVES[leaf]
        else:
            c, key = "params", flax_param_path(name, t.dim(), towers, bb, elan)[-1]
        if leaf == "relative_position_bias_table" and frame_size is not None:
            t = t[torch.from_numpy(_table_slice(_side(t.shape[0]), _jax_table_side(
                name, t.shape[0], frame_size)).reshape(-1))]
        t = t.detach().cpu()
        if leaf == "weight" and path and path[-1] in _DENSE_AS_CONV and t.dim() == 4:
            t = t[:, :, 0, 0].t()                       # (out,in,1,1) -> (in,out)
        elif leaf == "weight" and t.dim() == 4:         # OIHW -> HWIO
            t = t.permute(2, 3, 1, 0)
        elif leaf == "weight" and t.dim() == 2:         # (out,in) -> (in,out)
            t = t.t()
        if len(path) > 1 and path[-2] in ("self_attn", "cross_attn") and path[-1] in _MHA_PROJ:
            if heads is None:
                raise ValueError(f"{name}: an attention projection needs `heads`")
            if path[-1] == "out":
                t = t.reshape(heads, -1, t.shape[-1]) if leaf == "weight" else t
            else:
                t = t.reshape(t.shape[0], heads, -1) if leaf == "weight" else t.reshape(heads, -1)
        t = t.contiguous()
        node = out[c]
        for p in path:
            node = node.setdefault(p, {})
        node[key] = t if t.dtype == torch.bfloat16 else t.numpy()
    return out


def load_reference_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference `.pth` checkpoint's model state_dict, on the CPU
    (weights_only). Load it with `model.load_state_dict(sd,
    strict=False)`: its extra keys are the reference modules the port
    has no counterpart for."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return dict(ckpt.get("model", ckpt))
