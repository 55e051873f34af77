"""The port's mesh_scaling (blaze_tpu_torch/tools/mesh_scaling.py) on the
CPU, held to the JAX package's tools/mesh_scaling.py and its exchange.

- At D = 2 logical CPU devices and P = 4 the tool's JSON line has the
  reference's keys, says the devices are logical, and accounts for every
  row it sent.
- The exchange it times gives each device the same rows (as a multiset),
  the same per-partition counts and the same overflow as the JAX package's
  `mesh_shuffle_batch_grouped` in shard_map over the first D devices of the
  8-device virtual CPU mesh, on the tool's seeded draw.

No timing is asserted.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP

from blaze_tpu.columnar import types as JT
from blaze_tpu.columnar.batch import ColumnBatch as JBatch
from blaze_tpu.parallel import shuffle as jshuffle
from blaze_tpu.parallel import stage_exchange as jstage
from blaze_tpu_torch.tools import mesh_scaling

REF_KEYS = {"devices", "partitions", "rows_per_device", "exchange_ms",
            "bytes_per_s"}


def test_json_line_has_the_reference_keys(capsys):
    assert mesh_scaling.main(["4", "--devices", "2", "--device", "cpu",
                              "--rows", "256"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert REF_KEYS <= set(rec)
    assert rec["devices"] == 2 and rec["partitions"] == 4
    assert rec["rows_per_device"] == 256
    assert rec["logical"] is True and rec["device"] == "cpu"
    assert rec["rows_received"] == 512 and rec["overflow"] == 0
    assert "launch cost" in rec["note"] and "multi-card" in rec["note"]


def _rows(cols, n):
    k, v = (np.asarray(c)[:n] for c in cols)
    return sorted(zip(k.tolist(), v.tolist()))


def _jax_exchange(D, P, rows):
    """The JAX tool's step over the first D virtual devices, on its draw:
    (each device's rows, its counts) and the overflow."""
    schema = JT.Schema([JT.Field("k", JT.INT64), JT.Field("v", JT.FLOAT64)])
    kpd = -(-P // D)
    rng = np.random.default_rng(3)
    n = D * rows
    batch = JBatch.from_numpy(
        {"k": rng.integers(0, 1 << 20, n).astype(np.int64),
         "v": rng.random(n)}, schema, capacity=n)
    num_rows = jnp.full((D,), rows, jnp.int32)
    mesh = Mesh(np.array(jax.devices()[:D]), ("p",))

    def step(local_cols, local_num_rows):
        b = JBatch(schema, local_cols, local_num_rows[0], rows)
        out, counts, overflow = jshuffle.mesh_shuffle_batch_grouped(
            b, [0], "p", P, kpd, quota=rows * kpd)
        return out.columns, out.num_rows[None], counts[None], overflow[None]

    run = jax.jit(jstage._shard_map(
        step, mesh=mesh, in_specs=(JP("p"), JP("p")),
        out_specs=(JP("p"), JP("p"), JP("p"), JP("p"))))
    cols, out_rows, counts, overflow = run(batch.columns, num_rows)
    cap = D * rows * kpd
    per_dev = []
    for d in range(D):
        dcols = [np.asarray(c.data if hasattr(c, "data") else c)
                 [d * cap:(d + 1) * cap] for c in cols]
        per_dev.append((_rows(dcols, int(out_rows[d])),
                        np.asarray(counts[d])))
    return per_dev, int(np.asarray(overflow).max())


@pytest.mark.parametrize("D,P", [(2, 4), (2, 3), (4, 16)])
def test_exchange_equals_jax(D, P):
    rows = 64
    devices, logical = mesh_scaling.exchange_devices(D, "cpu")
    assert logical and devices == [torch.device("cpu")] * D
    batches = mesh_scaling.make_batches(devices, rows)
    outs, counts, overflow = mesh_scaling.exchange(batches, devices, P,
                                                   rows)
    want, want_over = _jax_exchange(D, P, rows)
    assert int(overflow) == want_over == 0
    for d in range(D):
        wrows, wcounts = want[d]
        np.testing.assert_array_equal(counts[d].numpy(), wcounts)
        got = outs[d].to_numpy()
        assert sorted(zip(got["k"].tolist(), got["v"].tolist())) == wrows
    assert sum(int(o.num_rows) for o in outs) == D * rows
