"""Rescale parameter(s) in every .covmat file in a directory.

Usage: python -m getdist_tpu_torch.covscale in_dir out_dir p1:p2:.. fac1:fac2:..
(role of reference ``getdist/covscale.py``).
"""

import os
import sys

from getdist_tpu_torch.covmat import CovMat

USAGE = (
    "covscale rescales parameter(s) in all .covmat files in a directory and outputs to another directory\n"
    "Usage: python -m getdist_tpu_torch.covscale in_dir out_dir param1:param2:.. fac1:fac2:.."
)


def rescale_covmats(in_dir, out_dir, scalings):
    """Apply {param: factor} scalings to each .covmat under in_dir, writing
    same-named files under out_dir (created if needed)."""
    os.makedirs(out_dir, exist_ok=True)
    for name in sorted(os.listdir(in_dir)):
        if not name.endswith(".covmat"):
            continue
        source = os.path.join(in_dir, name)
        print(source)
        cov = CovMat(source)
        for par, factor in scalings.items():
            cov.rescaleParameter(par, factor)
        cov.saveToFile(os.path.join(out_dir, name))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 4:
        print(USAGE)
        return 1
    names = argv[2].split(":")
    factors = [float(s) for s in argv[3].split(":")]
    rescale_covmats(os.path.abspath(argv[0]), os.path.abspath(argv[1]), dict(zip(names, factors)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
