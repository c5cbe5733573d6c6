"""Model export for deployment (counterpart of tools/export.py): the
port's forward as a `torch.export` program, whose graph holds the hand
kernels as `tscd::` ops (`ops/kernels/ops.py`), saved as a `.pt2` file.

    python -m tscd_torch.tools.export -n yolox-l -c ckpt.pth \\
        --output yolox_l.pt2 [--tsize 640] [--batch 1] [--raw] [--int8]
    python -m tscd_torch.tools.export -f exp.py --video --output tscd.pt2

A YOLOX exp exports `img (B, H, W, 3) float32 -> decoded (B, A, 5 + C)`
(`--raw`: the raw head output, reg and obj/cls LOGITS, which the C++
runner decodes); `--video` exports the TSCD streaming step `(frames (F, H,
W, 3), time_emb (F, 256), the matcher state's 7 tensors) -> (the refined
Detections' 5 tensors, the original's 5, the new state's 7)`, which a
consumer threads from window to window as the port's evaluator does.
Being a traced program, it proves the step's fixed shapes: a host read, a
data-dependent shape or a branch on a tensor's value fails the export.
`--int8` exports the w8a8 forward with dynamic activation scales
(`models.blocks.int8_eval`). Without -c the weights are random (seeded
from the exp's seed).

The file is loaded back (`torch.export.load(...).module()`) and run on
the same input as the eager forward, and the largest difference printed.
With `--raw` the CLI also compiles the saved program by AOTInductor into
a package, `<output stem>.aoti.pt2`, which `csrc/host/aoti_runner.cpp` loads with the
C++ ops of `csrc/torch_ops.cpp`: the counterpart of the StableHLO that
tscd_tpu/native/pjrt_runner.cpp loads. Runs on the card unless --device
says otherwise. Exp overrides (`key value` pairs) go after every flag.
Prints one JSON line.
"""

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional

import torch
from torch import nn


def make_parser():
    p = argparse.ArgumentParser("export (PyTorch port)")
    p.add_argument("-f", "--exp_file", type=str, default=None)
    p.add_argument("-n", "--name", type=str, default=None)
    p.add_argument("-c", "--ckpt", type=str, default=None)
    p.add_argument("--output", type=str, default="model.pt2")
    p.add_argument("--tsize", type=int, default=None)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--video", action="store_true",
                   help="export the TSCD streaming step: (frames, time_emb, matcher "
                        "state) -> (refined dets, original dets, new state)")
    p.add_argument("--int8", action="store_true",
                   help="export the w8a8 int8 forward (dynamic activation scales)")
    p.add_argument("--raw", action="store_true",
                   help="export the RAW head output (B, A, 5+C logits) and compile it "
                        "into the AOTInductor package the C++ runner loads")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the card (cuda) unless given")
    p.add_argument("opts", nargs="*")
    return p


class StillForward(nn.Module):
    """A YOLOX's exported forward: the raw head output or the decoded one."""

    def __init__(self, model, raw: bool):
        super().__init__()
        self.model, self.raw = model, raw

    def forward(self, img):
        out = self.model(img, decode=not self.raw)
        return out["outputs"] if self.raw else out["decoded"]


class TSCDStep(nn.Module):
    """The TSCD streaming eval step on flat tensors: the window and the
    matcher state's fields in, the refined and original Detections'
    fields (tscd_eval_postprocess at its defaults) and the new state's
    out."""

    def __init__(self, model, lframe: int, gframe: int):
        super().__init__()
        self.model, self.lframe, self.gframe = model, lframe, gframe

    def forward(self, frames, time_emb, *state):
        from tscd_torch.models.matching import MatcherState
        from tscd_torch.models.tscd import tscd_eval_postprocess
        out = self.model(frames, time_emb, self.lframe, self.gframe,
                         matcher_state=MatcherState(*state))
        refined, original = tscd_eval_postprocess(out, self.lframe, self.model.num_classes)
        return (*refined, *original, *out["matcher_state"])


def fresh_state(model):
    """The matcher state of a sequence start for `model` (a TSCD)."""
    from tscd_torch.models.matching import init_matcher_state
    head = model.head
    return tuple(init_matcher_state(head.num_proposals, head.hidden, 4 * head.hidden,
                                    dtype=model.dtype, device=model.device))


def build_model(exp, ckpt: Optional[str], device, int8: bool):
    """The exp's model on `device` in eval mode: seeded random weights, then
    the checkpoint's; prepared for int8 (from its fp32 weights) with
    `int8`."""
    from tscd_torch.models.tscd import random_init_
    from tscd_torch.tools.tscd_eval import load_weights
    from tscd_torch.utils.model_utils import prepare_int8
    model = exp.get_model(device=device)
    random_init_(model, exp.seed or 0)
    if ckpt:
        load_weights(model, ckpt)
    model.eval()
    if int8:
        prepare_int8(model)
    return model


def example_inputs(exp, model, video: bool, batch: int, device, seed: int = 0):
    """Seeded inputs at the exported shapes: a still batch (0-255 float32)
    or a window, its time embedding and a fresh matcher state."""
    import numpy as np

    from tscd_torch.ops.position import get_timing_signal_1d
    H, W = exp.test_size
    rng = np.random.default_rng(seed)
    if not video:
        return (torch.as_tensor(rng.integers(0, 256, (batch, H, W, 3)).astype(np.float32),
                                device=device),)
    F = exp.lframe_val + exp.gframe_val
    x = torch.as_tensor(rng.integers(0, 256, (F, H, W, 3)).astype(np.float32), device=device)
    te = torch.as_tensor(get_timing_signal_1d(np.arange(F), 256), dtype=torch.float32,
                         device=device)
    return (x, te, *fresh_state(model))


def max_diff(got, want) -> float:
    """The largest |got - want| over matching tensors (bool and int as
    numbers)."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    return max(float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
               for g, w in zip(got, want))


def _cuda_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def export_program(module: nn.Module, inputs, path: str):
    """torch.export of `module` on `inputs` (no grad), saved to `path`;
    returns the ExportedProgram and the seconds it took."""
    t0 = time.perf_counter()
    with torch.no_grad():
        ep = torch.export.export(module, tuple(inputs))
    torch.export.save(ep, path)
    return ep, time.perf_counter() - t0


BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "build")


def _links_openmp(cxx: str) -> bool:
    os.makedirs(BUILD, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as d:
        src = os.path.join(d, "t.cpp")
        with open(src, "w") as f:
            f.write("int main() { return 0; }\n")
        r = subprocess.run([cxx, "-fopenmp", src, "-o", os.path.join(d, "t")],
                           capture_output=True)
        return r.returncode == 0


def wrapper_compiler() -> str:
    """The C++ compiler AOTInductor builds its wrapper with: its own choice
    ($CXX, else g++), unless that one cannot link -fopenmp, which inductor
    passes to every gcc link (a gcc whose prefix lacks libgomp.spec); then
    the g++ on PATH."""
    own = os.environ.get("CXX", "g++")
    if _links_openmp(own):
        return own
    path = shutil.which("g++")
    if path is None or not _links_openmp(path):
        raise RuntimeError(f"AOTInductor needs a C++ compiler that links -fopenmp; {own} "
                           "cannot and no g++ on PATH can")
    return path


def aoti_package(ep, path: str) -> Dict:
    """AOTInductor compile of the ExportedProgram `ep` into the package
    `path` (the C++ wrapper, its Triton kernels for the card and the
    weights); returns the package's path, the compiler and the seconds."""
    from torch._inductor import aoti_compile_and_package
    # inductor's cache (generated sources, objects, cubins) inside the checkout
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", os.path.join(BUILD, "inductor"))
    cxx = wrapper_compiler()
    t0 = time.perf_counter()
    with torch._inductor.config.patch({"cpp.cxx": (None, cxx)}):
        out = aoti_compile_and_package(ep, package_path=os.path.abspath(path))
    return {"package": out, "cxx": cxx, "compile_s": time.perf_counter() - t0}


def package_path(output: str) -> str:
    """The AOTInductor package written beside the exported file `output`."""
    return os.path.splitext(output)[0] + ".aoti.pt2"


def export(exp, ckpt=None, output="model.pt2", video=False, int8=False, raw=False, batch=1,
           device=None) -> Dict:
    """Exports the exp's model as the flags say (see the module's notes) and
    checks the saved program against the eager forward on seeded inputs:
    for `video` two windows, the state carried from the first into the
    second. Returns a record of what was written and measured. (The CLI
    then compiles a --raw program with `aoti_package`.)"""
    from tscd_torch.device import resolve_device
    from tscd_torch.models.blocks import int8_eval
    dev = resolve_device(device)
    mode = int8_eval if int8 else contextlib.nullcontext
    model = build_model(exp, ckpt, dev, int8)
    if video:
        module = TSCDStep(model, exp.lframe_val, exp.gframe_val)
    else:
        module = StillForward(model, raw)
    inputs = example_inputs(exp, model, video, batch, dev)
    rec = {"output": output, "video": video, "int8": int8, "raw": raw,
           "device": str(dev), "input_shapes": [list(t.shape) for t in inputs[:2]]}
    with mode(), torch.no_grad():
        ep, rec["export_s"] = export_program(module, inputs, output)
        loaded = torch.export.load(output).module()
        want = module(*inputs)
        got = loaded(*inputs)
        rec["ops"] = sorted({str(n.target) for n in ep.graph.nodes
                             if str(n.target).startswith("tscd.")})
        if video:
            n = len(inputs) - 2
            x2, te2 = example_inputs(exp, model, True, batch, dev, seed=1)[:2]
            want2 = module(x2, te2, *want[-n:])
            got2 = loaded(x2, te2, *got[-n:])
            rec["max_abs_diff_windows"] = [max_diff(got, want), max_diff(got2, want2)]
            rec["equal"] = all(torch.equal(g, w) for g, w in
                               zip((*got, *got2), (*want, *want2)))
        else:
            rec["max_abs_diff"] = max_diff(got, want)
            rec["equal"] = torch.equal(got, want)
            rec["output_shape"] = list(got.shape)
        if dev.type == "cuda":      # a forward's ms, CUDA events over 5 calls after 2
            rec["eager_ms"] = _cuda_ms(lambda: module(*inputs))
            rec["exported_ms"] = _cuda_ms(lambda: loaded(*inputs))
    print(f"exported {output} ({os.path.getsize(output)} bytes): {rec['ops']}")
    return rec


def main(argv=None):
    args = make_parser().parse_args(argv)
    from tscd_torch.exp import get_exp
    exp = get_exp(args.exp_file, args.name)
    exp.merge(args.opts)
    if args.tsize:
        exp.test_size = (args.tsize, args.tsize)
    rec = export(exp, args.ckpt, args.output, args.video, args.int8, args.raw, args.batch,
                 args.device)
    if args.raw:
        rec.update(aoti_package(torch.export.load(args.output), package_path(args.output)))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    sys.exit(main() and 0)
