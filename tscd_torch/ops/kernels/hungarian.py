"""Linear sum assignment (kernel 2 of the port).

Replaces tscd_tpu/ops/pallas/hungarian.py (`linear_sum_assignment_pallas`
-> `_kernel`) for n <= 128, and the XLA lowering the JAX package takes
for n > 128 (tscd_tpu/ops/hungarian.py:88-128), reached from the matcher
through ops/hungarian.masked_linear_sum_assignment. CUDA source:
tscd_torch/csrc/hungarian.cu, two kernels picked by n as JAX picks.
Jonker-Volgenant shortest augmenting path on a batch of square fp32
costs, col4row int32 out, equal element for element to the JAX solvers
(same fp32 steps, first-index argmin ties).

Bound: latency. Each matrix is n row insertions of dependent Dijkstra
steps (n(n+1)/2 on a sequence start's constant cost); on the main path
the matcher launches it once per local frame with B = 1, because frame
i's cost reads the bank frame i-1's assignment wrote. The kernel gives
each matrix one warp and no block barrier, so a step's chain is a
shared load, three adds, two warp minima and a shuffle. Past n = 128 a
block takes each matrix, a thread a column (ceil(n / 1024) past 1024),
with the cost rows read from global memory.
"""

import torch

from . import library


def _lsa_plain_one(cost: torch.Tensor) -> torch.Tensor:
    """The XLA lowering of tscd_tpu/ops/hungarian.py, step for step."""
    n = cost.shape[0]
    dev = cost.device
    inf = float("inf")
    ar = torch.arange(n, device=dev)
    u = torch.zeros(n, device=dev)
    v = torch.zeros(n, device=dev)
    row4col = torch.full((n,), -1, dtype=torch.int32, device=dev)
    col4row = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for cur in range(n):
        i = cur
        min_val = torch.zeros((), device=dev)
        remaining = torch.ones(n, dtype=torch.bool, device=dev)
        spc = torch.full((n,), inf, device=dev)
        path = torch.full((n,), -1, dtype=torch.int32, device=dev)
        sr = torch.zeros(n, dtype=torch.bool, device=dev)
        while True:
            sr[i] = True
            r = min_val + cost[i] - u[i] - v
            better = (r < spc) & remaining
            spc = torch.where(better, r, spc)
            path = torch.where(better, torch.full_like(path, i), path)
            masked = torch.where(remaining, spc, torch.full_like(spc, inf))
            j = int(torch.argmin(masked))          # first minimal index
            min_val = masked[j]
            remaining[j] = False
            nxt = int(row4col[j])
            if nxt < 0:
                sink = j
                break
            i = nxt
        u[cur] += min_val
        other = sr & (ar != cur)
        gathered = spc[col4row.clamp(0, n - 1).long()]
        u = u + torch.where(other, min_val - gathered, torch.zeros_like(u))
        v = v - torch.where(~remaining, min_val - spc, torch.zeros_like(v))
        j = sink
        while True:
            i = int(path[j])
            row4col[j] = i
            next_j = int(col4row[i])
            col4row[i] = j
            if i == cur:
                break
            j = next_j
    return col4row


def linear_sum_assignment_plain(cost: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (B, n, n) -> col4row (B, n) int32."""
    cost = cost.to(torch.float32)
    return torch.stack([_lsa_plain_one(c) for c in cost])


def linear_sum_assignment(cost: torch.Tensor) -> torch.Tensor:
    """(B, n, n) fp32 costs -> col4row (B, n) int32, the optimal column of
    each row, through the op `tscd::linear_sum_assignment` (`ops.py`). A
    CPU tensor takes the plain version; a CUDA tensor launches a kernel:
    one warp a matrix for n <= 128, one block a matrix for 128 < n <=
    4096. The cost carries no gradient through it."""
    if cost.dim() != 3 or cost.shape[1] != cost.shape[2]:
        raise ValueError(f"cost must be (B, n, n), got {tuple(cost.shape)}")
    if cost.device.type not in ("cpu", "cuda"):
        raise ValueError(f"linear_sum_assignment: unsupported device {cost.device}")
    return torch.ops.tscd.linear_sum_assignment(cost.detach())


def launch(cost: torch.Tensor) -> torch.Tensor:
    """One launch of the solver of n on a CUDA cost (the op's CUDA
    implementation)."""
    B, n, _ = cost.shape
    if not 1 <= n <= 4096:
        raise ValueError(f"n = {n} outside 1..4096")
    c = cost.detach().to(torch.float32).contiguous()
    out = torch.empty(B, n, dtype=torch.int32, device=cost.device)
    lib = library.load()
    solve = (lib.tscd_linear_sum_assignment if n <= 128
             else lib.tscd_linear_sum_assignment_block)
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = solve(c.data_ptr(), out.data_ptr(), B, n, stream)
    library.check(lib, rc, "linear_sum_assignment")
    linear_sum_assignment.launches += 1
    return out


linear_sum_assignment.launches = 0
