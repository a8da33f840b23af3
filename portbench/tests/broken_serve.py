"""The serve launcher with the search broken underneath: every answered id
moved to the next row. For the test that a served run with answers altered
where they are produced comes out not correct."""

import sys

from local_search_quantization_torch.index import Index

from portbench import serve_launch

_search = Index.search


def _altered(self, Q, k=100, **kw):
    res = _search(self, Q, k, **kw)
    return type(res)(res.dists, (res.ids + 1) % self.n)


if __name__ == "__main__":
    Index.search = _altered
    sys.exit(serve_launch.main())
