"""The port's multi-device executor in one process: `SpmdExchange` at world
1, `core.shard.shard` / `unshard`, `launch.mesh` and `run_ranks`.

At world 1 (one gloo rank, a `FileStore` group) `SpmdExchange` holds every
partition and must equal `LocalExchange` primitive by primitive, for every
dtype the wire moves; without its local permute the transpose is the
identity there, which the mutant test shows.  `shard` cuts every [P, ...]
tensor to a rank's rows and re-bases the piece tables' `multi` ids; a
world-1 `unshard` gives the graph back, and so does a world-2 one across
two ranks (a subprocess), for a graph and a `Col`, to every rank or to rank
0 alone; onto a device `shard` copies the rank's rows.  `pregel` on a world-1 `SpmdExchange` graph
equals the `LocalExchange` run bit for bit; `pregel_fused` refuses it.
`run_ranks` reports a failed rank with its traceback, stops a hung one
within its timeout, and the executor refuses a world that does not divide
P.  Sections (a)-(o) across ranks: `tests/test_torch_spmd_ranks.py`.
"""
from __future__ import annotations

import importlib
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch.distributed as dist  # noqa: E402

from repro_torch.core import Col, Graph, pregel_fused  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core.exchange import LocalExchange, SpmdExchange  # noqa: E402
from repro_torch.core.view import WireLog  # noqa: E402
from repro_torch.data import rmat  # noqa: E402
from repro_torch.kernels.segorder import Pieces  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.utils.spmd import run_ranks, shard, unshard  # noqa: E402

P = 4
DTYPES = (torch.float32, torch.bool, torch.bfloat16, torch.int8, torch.int32,
          torch.int16, torch.float8_e4m3fn)
PROC_TIMEOUT = 120


def _graph(p=P, scale=7):
    gd = rmat(scale, 8, seed=3)
    g = Graph.from_edges(gd.src, gd.dst, num_partitions=p, device="cpu")
    return alg.attach_out_degree(g, kernel_mode="ref").mapV(alg._pr_init)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A one-rank gloo group for this module."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _block(dtype, shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 40
    return (x > 0) if dtype == torch.bool else x.to(dtype)


def _bits(t):
    return t.contiguous().view(torch.uint8) if t.dtype != torch.bool else t


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_primitives_equal_local_at_world_1(world1, dtype):
    ex, loc = SpmdExchange(P), LocalExchange(P)
    assert (ex.world, ex.rank, ex.nl) == (1, 0, P)
    x = _block(dtype, (P, P, 3, 2))

    def same(got, want):
        # contiguous, as the kernels on the card take their inputs
        assert got.is_contiguous()
        assert torch.equal(_bits(got), _bits(want))
    same(ex.transpose(x), loc.transpose(x))
    same(ex.ring_transpose(x), loc.ring_transpose(x))
    for shift in range(-P, 2 * P + 1):
        same(ex.ppermute(x, shift), loc.ppermute(x, shift))
    y = x[:, 0]
    same(ex.all_gather_rows(y), loc.all_gather_rows(y))
    assert torch.equal(ex.home_rows(P), loc.home_rows(P))


def test_reductions_and_shape_checks_at_world_1(world1):
    ex = SpmdExchange(P)
    for v in (torch.tensor(3.5), torch.tensor([1, 7], dtype=torch.int32)):
        assert torch.equal(ex.psum(v), v) and torch.equal(ex.pmax(v), v)
    v = torch.tensor(2.0)
    ex.psum(v).add_(1)
    assert float(v) == 2.0                  # a reduction never writes x
    with pytest.raises(ValueError):
        ex.transpose(torch.zeros(P - 1, P))
    with pytest.raises(ValueError):
        ex.all_gather_rows(torch.zeros(P + 1, 2))


def _exchange_mutant(old: str, new: str):
    """core/exchange.py with one line edited, loaded as its own module."""
    orig = importlib.import_module("repro_torch.core.exchange")
    src = Path(orig.__file__).read_text()
    assert src.count(old) == 1
    mod = types.ModuleType("repro_torch.core.exchange_mutant")
    mod.__package__ = orig.__package__
    sys.modules[mod.__name__] = mod
    try:
        exec(compile(src.replace(old, new), orig.__file__, "exec"),
             mod.__dict__)
    finally:
        del sys.modules[mod.__name__]
    return mod


def test_transpose_without_local_permute_breaks_world_1(world1):
    x = _block(torch.float32, (P, P, 2))
    want = LocalExchange(P).transpose(x)
    assert torch.equal(SpmdExchange(P).transpose(x), want)
    mut = _exchange_mutant(
        "return recv.permute(perm).reshape((nl, self.p) + rest)",
        "return recv.reshape((nl, self.p) + rest)")
    assert not torch.equal(mut.SpmdExchange(P).transpose(x), want)


def _tensors(tree):
    from repro_torch.core import capture
    return capture.flatten(tree)[0]


def test_shard_takes_rows_and_rebases_multi():
    g = _graph()
    for world in (2, 4):
        nl = P // world
        parts = [shard(g, r, world) for r in range(world)]
        for r, part in enumerate(parts):
            assert part.s.p == P and part.host is None
            assert part.vmask.shape[0] == nl
            assert torch.equal(part.s.src_slot,
                               g.s.src_slot[r * nl:(r + 1) * nl])
            assert torch.equal(part.vdata["pr"],
                               g.vdata["pr"][r * nl:(r + 1) * nl])
            rank0 = float(g.wire_log.ships.sum()) if r == 0 else 0.0
            assert float(part.wire_log.ships.sum()) == rank0
        for side, pc in g.s.agg_pieces.items():
            v = pc.ptr.shape[1] - 1
            multi = torch.cat([part.s.agg_pieces[side].multi + r * nl * v
                               for r, part in enumerate(parts)])
            assert torch.equal(multi, pc.multi), side
            for part in parts:
                m = part.s.agg_pieces[side].multi
                assert m.numel() == 0 or (int(m.min()) >= 0
                                          and int(m.max()) < nl * v)
        assert any(pc.multi.numel() for pc in g.s.agg_pieces.values())
    with pytest.raises(ValueError):
        shard(g, 0, 3)


def test_shard_onto_a_device_copies_the_rows():
    g = _graph()
    part = shard(g, 1, 2, device="cpu")
    for t in _tensors(part.replace(ex=None)):
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()
    assert part.s.agg_perm["src"] is part.s.src_perm
    assert torch.equal(part.s.src_slot, g.s.src_slot[P // 2:])
    view = shard(g, 1, 2)
    assert view.s.src_slot.untyped_storage().data_ptr() == \
        g.s.src_slot.untyped_storage().data_ptr()


def test_unshard_round_trip_world_1(world1):
    g = _graph()
    g1 = shard(g, 0, 1).replace(ex=SpmdExchange(P))
    back = unshard(g1)
    assert isinstance(back.ex, LocalExchange) and back.ex.p == P
    a, b = _tensors(back.replace(ex=None, host=None)), _tensors(
        g.replace(ex=None, host=None))
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert isinstance(back.s.agg_pieces["dst"], Pieces)
    assert isinstance(back.wire_log, WireLog)


def test_pregel_world_1_equals_local(world1):
    pm = importlib.import_module("repro_torch.core.pregel")
    g = _graph()
    runs = [pm.pregel(gg, alg.pagerank_vprog(0.15), alg.pagerank_send,
                      "sum", default_msg={"m": torch.tensor(0.0)},
                      max_supersteps=6, skip_stale=None, transport="auto")
            for gg in (g, g.replace(ex=SpmdExchange(P)))]
    assert runs[0].supersteps == runs[1].supersteps
    a = _tensors(pm._carry(runs[0].graph))
    b = _tensors(pm._carry(runs[1].graph))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="SpmdExchange"):
        pregel_fused(g.replace(ex=SpmdExchange(P)), alg.pagerank_vprog(0.15),
                     alg.pagerank_send, "sum",
                     default_msg={"m": torch.tensor(0.0)})


def test_mesh_at_world_1(world1):
    assert mesh.make_graph_mesh() is dist.group.WORLD
    assert mesh.make_restore_mesh(1) is dist.group.WORLD
    assert mesh.in_group(mesh.make_graph_mesh())
    assert mesh.mesh_axis_sizes() == {"parts": 1}
    with pytest.raises(RuntimeError, match="needs 2"):
        mesh.make_graph_mesh(2)


# ---------------------------------------------------------------------------
# run_ranks and world-2 cases, in a subprocess (this file's __main__)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", autouse=True)
def cases():
    """The subprocess cases, started together when the module's first test
    starts; name -> (result, seconds since the start)."""
    t0 = time.monotonic()
    procs = {name: subprocess.Popen(
        [sys.executable, __file__, name], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name in ("fail", "hang",
                                                       "world2")}
    done = {}

    def get(name):
        if name not in done:
            proc = procs[name]
            try:
                out, err = proc.communicate(timeout=PROC_TIMEOUT)
            finally:
                if proc.poll() is None:
                    proc.kill()
            done[name] = (subprocess.CompletedProcess(
                proc.args, proc.returncode, out, err),
                time.monotonic() - t0)
        return done[name]
    yield get
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_run_ranks_reports_a_failed_rank(cases):
    out, _ = cases("fail")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "RuntimeError" in out.stdout and "--- rank 1" in out.stdout
    assert "ZeroDivisionError" in out.stdout


def test_run_ranks_stops_a_hung_rank_within_its_timeout(cases):
    out, took = cases("hang")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "TimeoutError" in out.stdout
    assert took < 60, took


def test_world_2_round_trip_and_refusal(cases):
    out, _ = cases("world2")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "round trip ok ok" in out.stdout
    assert "refused: a world of 2 ranks does not divide P=3" in out.stdout


def test_world_2_unshard_to_rank_0(cases):
    out, _ = cases("world2")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "to rank 0 ok none" in out.stdout


def _fail_body(rank, world, device):
    if rank == 1:
        return 1 / 0
    dist.barrier()           # rank 0 waits on its peer, which has failed


def _hang_body(rank, world, device):
    if rank == 0:
        dist.barrier()       # rank 1 never joins
    else:
        time.sleep(600)


def _world2_body(rank, world, device):
    g = _graph()
    part = shard(g, rank, world).replace(ex=SpmdExchange(P))
    back = unshard(part)
    a = _tensors(back.replace(ex=None, host=None))
    b = _tensors(g.replace(ex=None, host=None))
    b_graph = list(b)
    col = Col.from_numpy(np.arange(40) % 7, {"v": np.arange(40.0)}, p=P,
                         device="cpu")
    cback = unshard(shard(col, rank, world))
    a += _tensors((cback.keys, cback.values, cback.mask))
    b += _tensors((col.keys, col.values, col.mask))
    ok = (len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
          and isinstance(cback.ex, LocalExchange))
    # gathered to rank 0 alone: the same graph there, None on rank 1
    to0 = unshard(part, dst=0)
    if rank == 0:
        a0 = _tensors(to0.replace(ex=None, host=None))
        got0 = ("ok" if len(a0) == len(b_graph) and all(
            torch.equal(x, y) for x, y in zip(a0, b_graph)) else "differs")
    else:
        got0 = "none" if to0 is None else "a copy"
    try:
        SpmdExchange(3)
        refused = "not refused"
    except ValueError as e:
        refused = f"refused: {e}"
    return ("ok" if ok else "differs"), refused, got0


def _main(case: str) -> int:
    torch.set_num_threads(1)
    if case == "world2":
        res = run_ranks(_world2_body, 2, backend="gloo", device="cpu",
                        timeout=90)
        print("round trip", *[r[0] for r in res])
        print(res[0][1])
        print("to rank 0", *[r[2] for r in res])
        return 0
    body, timeout = {"fail": (_fail_body, 60), "hang": (_hang_body, 5)}[case]
    try:
        run_ranks(body, 2, backend="gloo", device="cpu", timeout=timeout)
    except RuntimeError as e:
        print("RuntimeError", str(e).splitlines()[0].split(": ", 1)[1])
        print(str(e))
    except TimeoutError as e:
        print("TimeoutError", e)
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1]))
