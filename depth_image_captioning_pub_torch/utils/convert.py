"""Convert a reference PyTorch checkpoint into the JAX trainer's msgpack
file (the counterpart of the JAX ``utils/convert.py``; the files it writes
are byte for byte the JAX convert's):

  python -m depth_image_captioning_pub_torch.utils.convert \\
      --kind resnet152 --src resnet152-imagenet1k_v2.pth --out resnet152.msgpack
  python -m depth_image_captioning_pub_torch.utils.convert \\
      --kind dpt --src omnidata_dpt_depth_v2.ckpt --out dpt.msgpack

Kinds: resnet152 (torchvision backbone -> AttentionGridEncoder variables),
dpt (Omnidata DPT-hybrid), decoder (a reference soft/hard/CD_/MD_ decoder
state dict), nic-decoder, depth-cnn, depth-mlp. Converting once lets every
later run read the ``.msgpack`` without unpickling the PyTorch file.
"""

from __future__ import annotations

import argparse

from depth_image_captioning_pub_torch.utils import torch_bridge as tb
from depth_image_captioning_pub_torch.utils.checkpoint import save_component

_CONVERTERS = {
    "resnet152": lambda sd: tb.encoder_to_flax(sd),
    "dpt": lambda sd: tb.dpt_to_flax(sd),
    "decoder": tb.attention_decoder_to_flax,
    "nic-decoder": tb.nic_decoder_to_flax,
    "depth-cnn": tb.depth_cnn_to_flax,
    "depth-mlp": tb.depth_mlp_to_flax,
}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--kind", required=True, choices=sorted(_CONVERTERS))
    p.add_argument("--src", required=True, help="torch .pth/.ckpt file")
    p.add_argument("--out", required=True, help="output .msgpack path")
    args = p.parse_args(argv)
    sd = tb.load_state_dict(args.src)
    tree = _CONVERTERS[args.kind](sd)
    path = save_component(args.out.removesuffix(".msgpack"), tree)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
