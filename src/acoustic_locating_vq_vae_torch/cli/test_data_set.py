"""Dataset check: iterate a SpecsDataset directory and report its shapes,
the reference's scripts/test_data_set.py fixed to the current 6-tuple.

    python -m acoustic_locating_vq_vae_torch.cli.test_data_set DIR

Counterpart of the JAX package's ``scripts/test_data_set.py``; it takes the
stage CLIs' flags, as the JAX script takes ``base_parser``'s, and uses none
of them: it reads files and prints, and touches no device.
"""

from __future__ import annotations

from .common import stage_parser

__all__ = ["main"]


def main(argv=None) -> None:
    p = stage_parser(__doc__.split("\n\n")[0])
    p.add_argument("dir", help="SpecsDataset directory")
    args = p.parse_args(argv)
    from ..data import SpecsDataset

    ds = SpecsDataset(args.dir)
    print(f"{len(ds)} samples; fs={ds.fs} NFFT={ds.NFFT} hop={ds.HOP_LENGTH}")
    for i in range(len(ds)):
        speech, rir, echoed, fs, theta, wiener = ds[i]
        if i < 5 or i == len(ds) - 1:
            print(f"  [{i}] speech {speech.shape} rir {rir.shape} echoed {echoed.shape} "
                  f"theta {float(theta.reshape(-1)[0]):+.3f} wiener {wiener.shape}")
    print("ok")


if __name__ == "__main__":
    main()
