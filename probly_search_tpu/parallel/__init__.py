"""Multi-chip execution (SPMD over a jax.sharding.Mesh).

The reference is strictly single-threaded (SURVEY §2.3: no parallelism of
any kind exists in it; the only concurrency artifact is a Mutex smoke test,
`tests/integrations_tests.rs:151-168`).  Distribution is therefore a
first-class NEW subsystem of this build, designed around one collective:

* **Doc sharding** (`dist_query.py`): each device owns the postings of the
  doc slots congruent to its shard id.  Queries broadcast (tiny job tables),
  each shard scores its local postings, and per-shard top-k results are
  `all_gather`-ed and reduced to the final top-k.  Global document
  frequencies are static per snapshot and premultiplied on host into the
  job scales, so the ONLY query-time collective is the O(k) top-k gather —
  the classic partition-by-document search layout, embarrassingly parallel.
* **Query-batch data parallelism**: a second mesh axis splits the batch;
  no collective crosses it.

Mesh axes: ("data", "docs").  The term-range sharding alternative trades
these collectives for prefix-locality; doc sharding wins because the
collective volume is k results instead of posting partials, and load
balances under power-law dfs.
"""

from .mesh import make_mesh
from .dist_query import ShardedDeviceIndex

__all__ = ["make_mesh", "ShardedDeviceIndex"]
