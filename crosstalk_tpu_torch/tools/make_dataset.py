"""Synthetic dataset generator in the reference's on-disk layout (port of
tools/make_dataset.py; the same flags write the same files and bytes).

Writes N paired tiles (`image_<ID>_alpha_<A>_(mixed|source).tif`, float64,
the bundled dataset's exact flavor) for pipeline and scale testing — e.g. an
IDR-scale stand-in when the real 40k-image corpus isn't mounted.

Usage: python -m crosstalk_tpu_torch.tools.make_dataset OUT_DIR [-n N]
       [--size 256] [--seed 0] [--preset uniform|microscopy|remix]
"""

from __future__ import annotations

import argparse
import sys

from crosstalk_tpu_torch.data.synthetic import _PRESETS, generate_dataset


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("out_dir")
    parser.add_argument("-n", "--num_pairs", type=int, default=1000)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--preset", type=str, default="uniform",
                        choices=sorted(_PRESETS) + ["remix"],
                        help="'uniform': v1 dense blocks, independent "
                             "channels. 'microscopy': matched to the real "
                             "bundled IDR tiles' statistics (sparse "
                             "log-skewed intensities, correlated channels, "
                             "faint raw source scale). 'remix': labeled "
                             "mixtures built FROM real tiles (needs "
                             "--real_mixed/--real_source; see data/remix.py)")
    parser.add_argument("--real_mixed", type=str, default=None,
                        help="remix only: directory of real mixed tiles")
    parser.add_argument("--real_source", type=str, default=None,
                        help="remix only: directory of real source tiles")
    parser.add_argument("--texture_split", type=str, default="all",
                        choices=["all", "train", "heldout"],
                        help="remix only: restrict the real-texture bank to "
                             "the deterministic 80/20 image-id split "
                             "(data/remix.py::split_texture_ids) so a "
                             "held-out corpus uses textures the training "
                             "corpus never saw")
    args = parser.parse_args(argv)

    if args.preset == "remix":
        if not (args.real_mixed and args.real_source):
            parser.error("--preset remix requires --real_mixed and --real_source")
        from crosstalk_tpu_torch.data.remix import (
            generate_remix_dataset,
            split_texture_ids,
        )
        ids = None
        if args.texture_split != "all":
            train_ids, hold_ids = split_texture_ids(
                args.real_mixed, args.real_source)
            ids = train_ids if args.texture_split == "train" else hold_ids
            print(f"texture bank: {len(ids)} image ids "
                  f"({args.texture_split} side of the 80/20 split)")
        generate_remix_dataset(
            args.out_dir, args.real_mixed, args.real_source,
            num_pairs=args.num_pairs, seed=args.seed, image_ids=ids)
    else:
        generate_dataset(args.out_dir, args.num_pairs, args.size, args.seed,
                         preset=args.preset)
    print(f"Wrote {args.num_pairs} pairs under {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
