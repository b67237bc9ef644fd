"""Merge .covmat files (earlier inputs take priority where parameters overlap).

Usage: python -m getdist_tpu_torch.covcomb out.covmat in1.covmat in2.covmat [...]
(role of reference ``getdist/covcomb.py``).
"""

import sys

from getdist_tpu_torch.covmat import CovMat

USAGE = "Usage: python -m getdist_tpu_torch.covcomb out.covmat in1.covmat in2.covmat [in3.covmat...]"


def combine_covmats(paths):
    """Merge covmats left to right; earlier entries win on overlap."""
    merged = CovMat(paths[0])
    for path in paths[1:]:
        print("merging: " + path)
        merged = merged.mergeCovmatWhereNew(CovMat(path))
    return merged


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(USAGE)
        return 1
    combine_covmats(argv[1:]).saveToFile(argv[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
