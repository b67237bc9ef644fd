"""Named-parameter covariance matrices (host-side; ``.covmat`` text format).

The port's own copy of ``getdist_tpu/covmat.py``. Format compatible with
the reference (``getdist/covmat.py``): a ``# name1 name2 ...`` header line
followed by the matrix in ``%15.7E`` columns. ``CovMat.plot`` imports
matplotlib when called, never at import.
"""

import numpy as np

__all__ = ["CovMat", "read_covmat_text", "write_covmat_text"]

_MATRIX_FORMAT = "%15.7E"


def read_covmat_text(filename):
    """Parse a ``.covmat`` file into ``(names, matrix)``.

    The first line must be a ``#``-prefixed header listing parameter names;
    the remainder is whitespace-separated numbers.
    """
    with open(filename, encoding="utf-8-sig") as handle:
        header = handle.readline().strip()
        if not header.startswith("#"):
            raise Exception(".covmat must now have parameter names header")
        names = header.lstrip("#").split()
        matrix = np.loadtxt(handle)
    return names, matrix


def write_covmat_text(filename, names, matrix):
    """Write the ``.covmat`` text format (names header + %15.7E matrix)."""
    with open(filename, "wb") as handle:
        handle.write(f"# {' '.join(names)}\n".encode())
        np.savetxt(handle, matrix, _MATRIX_FORMAT)


class CovMat:
    """Covariance matrix labeled by parameter names.

    :ivar matrix: square numpy array
    :ivar paramNames: list of parameter name strings
    """

    def __init__(self, filename="", matrix=None, paramNames=None):
        self.matrix = matrix
        self.size = 0 if matrix is None else matrix.shape[0]
        self.paramNames = list(paramNames) if paramNames else []
        if filename:
            self.loadFromFile(filename)

    def paramNameString(self):
        return " ".join(self.paramNames)

    def loadFromFile(self, filename):
        """Load a .covmat text file (see :func:`read_covmat_text`)."""
        self.paramNames, self.matrix = read_covmat_text(filename)
        self.size = len(self.paramNames)

    def saveToFile(self, filename):
        """Write this matrix via :func:`write_covmat_text`."""
        write_covmat_text(filename, self.paramNames, self.matrix)

    def _slot(self, name):
        try:
            return self.paramNames.index(name)
        except ValueError:
            return None

    def rescaleParameter(self, name, scale):
        """Rescale row+column of one parameter (for renormalized parameters)."""
        where = self._slot(name)
        if where is None:
            print("Not in covmat: " + name)
            return
        self.matrix[where, :] *= scale
        self.matrix[:, where] *= scale

    def mergeCovmatWhereNew(self, cov2):
        """Union of parameters: keep this matrix's entries where present,
        fill blocks only covered by cov2 from cov2, zero cross terms."""
        names = list(self.paramNames)
        names += [p for p in cov2.paramNames if p not in names]
        slot = {p: i for i, p in enumerate(names)}
        merged = CovMat(matrix=np.zeros((len(names), len(names))), paramNames=names)
        # write cov2's block first, then overwrite with this matrix's block
        # (earlier matrix wins on overlap); cross terms stay zero
        for source in (cov2, self):
            where = np.array([slot[p] for p in source.paramNames], dtype=int)
            merged.matrix[np.ix_(where, where)] = source.matrix
        return merged

    def subMatrix(self, names):
        """A new :class:`CovMat` restricted to (and ordered by) ``names``."""
        where = np.array([self.paramNames.index(p) for p in names], dtype=int)
        return CovMat(matrix=self.matrix[np.ix_(where, where)], paramNames=list(names))

    def correlation(self):
        """The correlation matrix derived from this covariance."""
        sigma = np.sqrt(np.diag(self.matrix))
        return self.matrix / np.outer(sigma, sigma)

    def plot(self):
        """Plot the correlation matrix as a colored grid."""
        from matplotlib import pyplot

        pyplot.pcolor(self.correlation())
        pyplot.colorbar()
        centers = 0.5 + np.arange(self.size)
        numbers = [str(i) for i in range(1, self.size + 1)]
        pyplot.yticks(centers, numbers)
        pyplot.gca().set_yticklabels(self.paramNames)
        pyplot.xticks(centers, numbers)
        pyplot.xlim([0, self.size])
        pyplot.ylim([0, self.size])
