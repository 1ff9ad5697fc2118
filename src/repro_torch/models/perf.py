"""Performance options (the reference's hillclimb knobs) on one card.

The port of `repro/models/perf.py`: a context variable of named options
that model code reads where the reference reads them.

  with perf.options(moe_capacity_factor=2.0, moe_groups=True):
      loss = T.loss_fn(params, batch, cfg)

Knobs that change something here:
  moe_capacity_factor -- the MoE buffers' capacity factor (`moe.moe_block`);
  moe_payload_dtype   -- the dtype (a torch dtype) of the token vectors
                         written into the MoE dispatch buffers;
  moe_groups          -- route each batch row on its own, with its own
                         capacity;
  mlstm_chunk         -- the mLSTM blocks' chunk (`transformer._apply_block`).

`remat_policy` picks what the reference's checkpoint keeps: nothing under
"nothing", dot products otherwise.  The port recomputes whole super-layers
under either (`transformer._run_stack`), so both give the same values and
the port reads nothing from it.  The sharding knobs (`act_spec`,
`moe_dispatch_spec`, `moe_expert_axis`) need the LM's mesh, which the port
does not have yet (the graph engine's process groups are
`launch/mesh.py`'s): `options(mesh=...)` raises, and `constrain` is the
identity.
"""
from __future__ import annotations

import contextlib
import contextvars

_OPTS: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "repro_torch_perf_opts", default={})


def get(name: str, default=None):
    return _OPTS.get().get(name, default)


@contextlib.contextmanager
def options(**kw):
    if kw.get("mesh") is not None:
        raise NotImplementedError("the LM's device mesh is not ported yet: "
                                  "ROADMAP Queue 1 item 4 (the LM mesh and "
                                  "sharding rules, with the XLA tooling)")
    tok = _OPTS.set({**_OPTS.get(), **kw})
    try:
        yield
    finally:
        _OPTS.reset(tok)


def constrain(x, spec_name: str):
    """The reference's sharding constraint named `spec_name`: the identity
    on one device (there is no mesh to shard over)."""
    return x
