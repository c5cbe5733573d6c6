"""Greedy NMS over boxes in score order (a port kernel with no Pallas
counterpart).

Replaces the IoU matrix and the XLA `lax.scan` of
tscd_tpu/ops/nms.py:43-53 (`nms_fixed`), the JAX package's exact greedy
NMS, which runs K dependent steps on the device and waits on nothing.
CUDA source: tscd_torch/csrc/nms.cu.

Given, in score order, boxes (B, K, 4) fp32 xyxy, valid (B, K) bool and
the threshold, it returns keep (B, K) bool with
keep[i] = valid[i] & !any_{j < i}(IoU(i, j) > thr & keep[j]).

Bound: latency. The K decisions form one dependent chain of at least one
integer operation each; the bytes (boxes and flags) and the K^2 / 2 IoUs
are far below it. The card runs two kernels: the pack computes each IoU
and its threshold and ballots them into a bit matrix of 32 x 32 tiles
(never the (K, K) float or bool tensors), over the whole card; the walk,
one warp a frame, settles 32 boxes a step: an OR of the row block's words
against the settled keep words, then its own triangle as a chain of
register operations. Each IoU operation is rounded on its own, in the
order of `ops/boxes.py:pairwise_iou_xyxy`, so the decisions equal the
torch IoU's bit for bit. On the main path it runs twice a window: over
K = P * C = 1500 (proposal, class) pairs and over K = P = 50 proposals.
"""

import torch

from ..boxes import pairwise_iou_xyxy
from . import library

KMAX = 16384
_CHECK_EVERY = 8


def overlap_matrix(boxes_s: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """(B, K, K) bool: [b, i, j] = box j comes before box i and overlaps it
    above the threshold (the matrix the kernels never write)."""
    K = boxes_s.shape[1]
    overlap = pairwise_iou_xyxy(boxes_s, boxes_s) > iou_threshold
    earlier = torch.ones(K, K, dtype=torch.bool, device=boxes_s.device).tril(-1)
    return overlap & earlier


def _fixed_point(sup: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """keep = valid & ~any_j(sup[i, j] & keep[j]), reached by masked
    matrix-vector products. After t steps the first t boxes are final and
    the greedy answer is the only fixed point, so the loop stops at the
    first step that changes nothing; convergence is tested every
    `_CHECK_EVERY` steps, one host read a test (harmless on the CPU,
    where this version runs)."""
    suppress = sup.to(torch.float32)
    keep = valid
    while True:
        for _ in range(_CHECK_EVERY):
            prev = keep
            hit = torch.bmm(suppress, keep.to(torch.float32)[..., None])[..., 0]
            keep = valid & ~(hit > 0)
        if torch.equal(keep, prev):
            return keep


def nms_sorted_plain(boxes_s: torch.Tensor, valid_s: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """Plain PyTorch version: the overlap matrix, then the fixed point."""
    return _fixed_point(overlap_matrix(boxes_s, iou_threshold), valid_s)


def tile_index(nb: int, device=None):
    """(row block c, word block w) of each tile, w <= c, in the kernels'
    order t = c (c + 1) / 2 + w."""
    return torch.tril_indices(nb, nb, device=device)


def pack_plain(boxes_s: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """The pack kernel's output from the overlap matrix: tiles (B, NT, 32)
    int32, NT = nb (nb + 1) / 2, nb = ceil(K / 32). Tile t = (c, w), w < c,
    holds row 32 c + r's word r over columns 32 w + l (bit l); the
    diagonal tile (c, c) holds box 32 c + l's column, word l, over the
    later rows 32 c + r of its block (bit r), the same decisions
    transposed. Rows and columns past K are 0."""
    B, K = boxes_s.shape[:2]
    nb = (K + 31) // 32
    sup = torch.zeros(B, 32 * nb, 32 * nb, dtype=torch.bool, device=boxes_s.device)
    sup[:, :K, :K] = overlap_matrix(boxes_s, iou_threshold)
    bits = sup.view(B, nb, 32, nb, 32).to(torch.int64)          # [b, c, r, w, l]
    shifts = torch.arange(32, device=sup.device)
    rows = (bits << shifts).sum(-1).permute(0, 1, 3, 2)        # [b, c, w, r]
    cols = (bits << shifts[:, None, None]).sum(2)              # [b, c, w, l]
    c, w = tile_index(nb, sup.device)
    tiles = torch.where((c == w)[:, None], cols[:, c, w], rows[:, c, w])
    return torch.where(tiles >= 2 ** 31, tiles - 2 ** 32, tiles).to(torch.int32)


def unpack(tiles: torch.Tensor, K: int) -> torch.Tensor:
    """The (B, K, K) bool matrix of pack tiles (zero on and above the
    diagonal)."""
    B = tiles.shape[0]
    nb = (K + 31) // 32
    words = torch.zeros(B, nb, nb, 32, dtype=torch.int64, device=tiles.device)
    c, w = tile_index(nb, tiles.device)
    words[:, c, w] = tiles.to(torch.int64) & 0xFFFFFFFF
    bits = (words[..., None] >> torch.arange(32, device=tiles.device)) & 1   # [b, c, w, x, y]
    diag = torch.eye(nb, dtype=torch.bool, device=tiles.device)[None, :, :, None, None]
    # below the diagonal x is the row and y the column; on it, the reverse
    bits = torch.where(diag, bits.transpose(3, 4), bits)
    return bits.permute(0, 1, 3, 2, 4).reshape(B, 32 * nb, 32 * nb)[:, :K, :K].bool()


def _check(boxes_s: torch.Tensor, valid_s, what: str):
    if boxes_s.dim() != 3 or boxes_s.shape[-1] != 4:
        raise ValueError(f"{what} takes boxes (B, K, 4), got {tuple(boxes_s.shape)}")
    if boxes_s.dtype != torch.float32:
        raise ValueError(f"{what} takes fp32 boxes, got {boxes_s.dtype}")
    if valid_s is not None:
        if valid_s.shape != boxes_s.shape[:2] or valid_s.dtype != torch.bool:
            raise ValueError(f"{what} takes valid (B, K) bool, got "
                             f"{tuple(valid_s.shape)} {valid_s.dtype}")
        if valid_s.device != boxes_s.device:
            raise ValueError(f"{what}: boxes on {boxes_s.device}, valid on {valid_s.device}")
    if boxes_s.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {boxes_s.device}")
    if boxes_s.device.type == "cuda":
        B, K = boxes_s.shape[:2]
        if not 1 <= K <= KMAX or not 1 <= B <= 65535:
            raise ValueError(f"{what} takes 1 <= K <= {KMAX} and 1 <= B <= 65535, "
                             f"got K = {K}, B = {B}")
        if not boxes_s.is_contiguous() or (valid_s is not None
                                           and not valid_s.is_contiguous()):
            raise ValueError(f"{what} takes contiguous tensors")


def _scratch(boxes_s: torch.Tensor):
    """The kernels' scratch, and the tiles in it: the B frames' tiles
    (B, NT, 32), then each row block's invalid rows (B, nb)."""
    B, K = boxes_s.shape[:2]
    nb = (K + 31) // 32
    nt = nb * (nb + 1) // 2
    scratch = torch.empty(B * (nt * 32 + nb), dtype=torch.int32, device=boxes_s.device)
    return scratch, scratch[:B * nt * 32].view(B, nt, 32)


def pack(boxes_s: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """The pack alone (for checks): boxes (B, K, 4) fp32 in score order ->
    tiles as `pack_plain` lays them out. A CPU tensor takes `pack_plain`;
    a CUDA tensor launches the pack kernel."""
    _check(boxes_s, None, "pack")
    if boxes_s.device.type == "cpu":
        return pack_plain(boxes_s, iou_threshold)
    B, K = boxes_s.shape[:2]
    scratch, tiles = _scratch(boxes_s)
    valid = torch.ones(B, K, dtype=torch.bool, device=boxes_s.device)
    lib = library.load()
    with torch.cuda.device(boxes_s.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tscd_nms_pack(boxes_s.data_ptr(), valid.data_ptr(), scratch.data_ptr(), B, K,
                               float(iou_threshold), stream)
    library.check(lib, rc, "nms pack")
    pack.launches += 1
    return tiles


def nms_sorted(boxes_s: torch.Tensor, valid_s: torch.Tensor,
               iou_threshold: float) -> torch.Tensor:
    """boxes (B, K, 4) fp32 xyxy and valid (B, K) bool, both in score
    order -> keep (B, K) bool in that order. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernels (K <= KMAX) and never
    reads the host."""
    _check(boxes_s, valid_s, "nms_sorted")
    if boxes_s.device.type == "cpu":
        return nms_sorted_plain(boxes_s, valid_s, iou_threshold)
    B, K = valid_s.shape
    scratch, _ = _scratch(boxes_s)
    keep = torch.empty(B, K, dtype=torch.bool, device=boxes_s.device)
    lib = library.load()
    with torch.cuda.device(boxes_s.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tscd_nms_sorted(boxes_s.data_ptr(), valid_s.data_ptr(), scratch.data_ptr(),
                                 keep.data_ptr(), B, K, float(iou_threshold), stream)
    library.check(lib, rc, "nms_sorted")
    nms_sorted.launches += 1
    return keep


pack.launches = 0
nms_sorted.launches = 0
