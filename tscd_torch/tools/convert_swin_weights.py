"""An official Swin Transformer checkpoint in JAX's layout (counterpart of
tools/convert_swin_weights.py), with no flax: the port's converter
(`utils.convert.backbone_to_flax`) renames and transposes the network's
weights, and the port's msgpack writer writes {"params": ...} as flax's
`msgpack_serialize` would. The buffers JAX recomputes
(`relative_position_index`, `attn_mask`) and the classifier (`norm`,
`head`) are left out.

    python -m tscd_torch.tools.convert_swin_weights swin_tiny.pth out.msgpack
"""

import argparse

import torch

from tscd_torch.utils.convert import backbone_to_flax
from tscd_torch.utils.flax_msgpack import write_msgpack


def main(argv=None) -> str:
    p = argparse.ArgumentParser("swin weight converter (PyTorch port)")
    p.add_argument("src", help="an official Swin .pth (its 'model' or 'state_dict' entry)")
    p.add_argument("dst", help="the .msgpack to write")
    args = p.parse_args(argv)
    ckpt = torch.load(args.src, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
    write_msgpack(args.dst, {"params": backbone_to_flax(sd, "swin")["params"]})
    print(f"wrote {args.dst}")
    return args.dst


if __name__ == "__main__":
    main()
