"""Graph runtime: LayerSpec / layer registry / Net.

A re-design of Caffe's Net (`src/caffe/net.cpp`, ~1100 LoC) and layer
factory (`src/caffe/layer_factory.cpp`):

* ``LayerSpec`` is the NetParameter/LayerParameter analogue — a plain dataclass
  graph description (name, type, bottoms, tops, per-type params, phase).
* ``@register_layer`` is the `REGISTER_LAYER_CLASS` analogue.
* ``Net`` builds the layer list, infers shapes via `jax.eval_shape` (replacing
  Caffe's imperative Reshape propagation), and exposes a *pure functional*
  ``apply(params, inputs)`` — so the whole forward (and grad of it) jits and
  pjits. There is no mutable blob state: blobs are a dict threaded through the
  topological layer order, which also subsumes Caffe's insert_splits
  (`src/caffe/util/insert_splits.cpp`) since a blob can be read many times.
* ``Net.weight_align(params)`` is the sparse-compile hook
  (`Net::CopyTrainedLayersFrom` -> `layer->WeightAlign()`, `net.cpp:819`):
  a host-side pass converting conv/FC weights into AlignedConvWeight pytrees
  according to each layer's ExecutionPolicy.

Per-layer timing categories mirror `Net::Get{Conv,Fc,Data,Other}Time`
(`net.cpp:516-565`); the timing harness lives in utils/timing.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from caffe_escoin_tpu.engine.context import ConvMode, ExecutionPolicy


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    name: str
    type: str
    bottoms: Tuple[str, ...] = ()
    tops: Tuple[str, ...] = ()
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    phase: Optional[str] = None  # "train" | "test" | None (both)
    loss_weight: float = 0.0
    # Caffe param-sharing (`param { name: ... }`, net.cpp param ownership):
    # use another layer's params (siamese nets, tied weights)
    share_params: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "bottoms", tuple(self.bottoms))
        tops = tuple(self.tops) if self.tops else (self.name,)
        object.__setattr__(self, "tops", tops)


LAYER_REGISTRY: Dict[str, type] = {}


def register_layer(type_name: str):
    def deco(cls):
        if type_name in LAYER_REGISTRY:
            raise ValueError(f"duplicate layer type {type_name!r}")
        LAYER_REGISTRY[type_name] = cls
        cls.type_name = type_name
        return cls

    return deco


class Layer:
    """Base layer contract (reference `include/caffe/layer.hpp`):
    init (SetUp) / apply (Forward; Backward is jax.grad) / align (WeightAlign).
    """

    category = "other"  # timing bucket: conv | fc | data | other
    type_name = "?"

    def __init__(self, spec: LayerSpec, policy: ExecutionPolicy):
        self.spec = spec
        self.policy = policy
        self.p = dict(spec.params)

    # non-trainable mutable buffers (moving stats etc.). Kept in a SEPARATE
    # collection from params so the solver never touches them — the reference
    # marks these blobs lr_mult 0 (BatchNorm's mean/var/scale blobs,
    # `src/caffe/layers/batch_norm_layer.cpp:30-46`).
    has_state = False

    # -- parameters --------------------------------------------------------
    def init_params(self, rng, in_shapes: List[Tuple[int, ...]]):
        return {}

    def init_state(self, in_shapes: List[Tuple[int, ...]]):
        """Initial non-trainable buffers; only called when has_state."""
        return {}

    def align(self, params):
        """Host-side sparse compile; default no-op (layer.hpp:98)."""
        return params

    # -- forward -----------------------------------------------------------
    def apply(self, params, inputs: List[jax.Array], *, train: bool, rng):
        raise NotImplementedError

    def apply_stateful(self, params, state, inputs, *, train: bool, rng):
        """(outs, new_state). Default: stateless layers pass state through.
        Stateful layers (has_state=True) override this instead of apply."""
        return self.apply(params, inputs, train=train, rng=rng), state

    def out_shapes(self, params, in_shapes) -> List[Tuple[int, ...]]:
        outs = jax.eval_shape(
            lambda p, xs: self.apply(p, xs, train=False, rng=None),
            params,
            [jax.ShapeDtypeStruct(s, jnp.float32) for s in in_shapes],
        )
        return [o.shape for o in outs]


class Net:
    """Functional graph executor over a LayerSpec list."""

    def __init__(
        self,
        specs: Sequence[LayerSpec],
        *,
        policy: Optional[ExecutionPolicy] = None,
        phase: str = "test",
    ):
        self.policy = policy or ExecutionPolicy()
        self.phase = phase
        self.specs = [s for s in specs if s.phase in (None, phase)]
        self.layers: List[Layer] = []
        for s in self.specs:
            if s.type not in LAYER_REGISTRY:
                raise KeyError(
                    f"layer type {s.type!r} not registered "
                    f"(known: {sorted(LAYER_REGISTRY)})"
                )
            layer_policy = self.policy
            if "policy" in s.params:
                layer_policy = s.params["policy"]
            self.layers.append(LAYER_REGISTRY[s.type](s, layer_policy))

    # ------------------------------------------------------------------
    def init(self, rng, input_shapes: Dict[str, Tuple[int, ...]]):
        """Returns params: dict layer_name -> pytree. Also caches blob shapes
        and the initial buffer state (`self.state0`: layer_name -> buffers,
        for has_state layers — use `init_with_state` to receive it)."""
        params: Dict[str, Any] = {}
        state0: Dict[str, Any] = {}
        shapes: Dict[str, Tuple[int, ...]] = dict(input_shapes)
        for layer in self.layers:
            spec = layer.spec
            in_shapes = [shapes[b] for b in spec.bottoms]
            rng, sub = jax.random.split(rng)
            if spec.share_params is not None:
                if spec.share_params not in params:
                    raise KeyError(
                        f"{spec.name}: share_params target "
                        f"{spec.share_params!r} not initialized yet"
                    )
                p = params[spec.share_params]
            else:
                p = layer.init_params(sub, in_shapes)
                if p:
                    params[spec.name] = p
            if layer.has_state:
                state0[spec.name] = layer.init_state(in_shapes)
            outs = layer.out_shapes(p, in_shapes)
            for t, o in zip(spec.tops, outs):
                shapes[t] = tuple(o)
        self.blob_shapes = shapes
        self.state0 = state0
        return params

    def init_with_state(self, rng, input_shapes):
        """(params, state): the trainable / buffer split. state carries
        moving statistics (BatchNorm) — thread it through apply/loss with
        return_state=True during training and pass the final state to
        inference (the reference's blobs[0..2] persisted in .caffemodel)."""
        params = self.init(rng, input_shapes)
        return params, self.state0

    # ------------------------------------------------------------------
    def apply(
        self,
        params: Dict[str, Any],
        inputs: Dict[str, jax.Array],
        *,
        train: bool = False,
        rng=None,
        return_blobs: bool = False,
        state: Optional[Dict[str, Any]] = None,
        return_state: bool = False,
    ):
        """Topological forward. Returns dict of final tops (blobs never read
        by a later layer), or all blobs with return_blobs=True.

        ``state`` is the buffer collection (init_with_state); None uses the
        freshly-initialized buffers from init (untrained moving stats). With
        ``return_state=True`` the result is ``(result, new_state)`` — in train
        mode new_state carries the moving-average updates (the reference
        mutates its BN blobs in Forward, `batch_norm_layer.cpp:125-145`; here
        the update is an explicit functional output so the whole step jits).
        """
        blobs: Dict[str, jax.Array] = dict(inputs)
        if state is None:
            state = getattr(self, "state0", {})
        new_state = dict(state)
        consumed = set()
        for layer in self.layers:
            spec = layer.spec
            ins = [blobs[b] for b in spec.bottoms]
            consumed.update(spec.bottoms)
            if rng is not None:
                rng, sub = jax.random.split(rng)
            else:
                sub = None
            pkey = spec.share_params or spec.name
            if layer.has_state:
                lstate = state.get(spec.name)
                if not lstate:
                    # net used without init() (e.g. params loaded from a
                    # checkpoint): fall back to freshly-initialized buffers,
                    # sized from the live blobs
                    lstate = layer.init_state([tuple(b.shape) for b in ins])
                outs, st = layer.apply_stateful(
                    params.get(pkey, {}), lstate, ins,
                    train=train, rng=sub,
                )
                if train:
                    new_state[spec.name] = st
            else:
                outs = layer.apply(params.get(pkey, {}), ins, train=train,
                                   rng=sub)
            if not isinstance(outs, (list, tuple)):
                outs = [outs]
            for t, o in zip(spec.tops, outs):
                blobs[t] = o
        if return_blobs:
            result = blobs
        else:
            all_tops = [t for l in self.layers for t in l.spec.tops]
            # `t in blobs` guards layers that legitimately emit no tops
            # (Silence consumes bottoms and produces nothing)
            finals = [t for t in all_tops if t not in consumed and t in blobs]
            result = {t: blobs[t] for t in dict.fromkeys(finals)}
        if return_state:
            return result, new_state
        return result

    # ------------------------------------------------------------------
    def loss(self, params, inputs, *, train: bool = True, rng=None,
             state: Optional[Dict[str, Any]] = None,
             return_state: bool = False):
        """Weighted sum of loss-layer tops (Caffe loss_weight semantics)."""
        blobs, new_state = self.apply(
            params, inputs, train=train, rng=rng, return_blobs=True,
            state=state, return_state=True,
        )
        total = 0.0
        for layer in self.layers:
            w = layer.spec.loss_weight
            if w:
                total = total + w * blobs[layer.spec.tops[0]]
        if return_state:
            return total, new_state
        return total

    # ------------------------------------------------------------------
    def weight_align(self, params):
        """Host-side sparse compile of all layers' params (net.cpp:819)."""
        out = dict(params)
        for layer in self.layers:
            name = layer.spec.name
            if name in out:
                out[name] = layer.align(out[name])
        return out

    # ------------------------------------------------------------------
    def inference_fn(self, aligned_params, *, align: bool = False,
                     state: Optional[Dict[str, Any]] = None,
                     weights_as_args: bool = False):
        """Jitted forward with the sparsity PATTERN closed over (concrete
        at trace time — what enables the XBSP executor,
        kernels/xla_block_sparse.py, the fastest sparse-conv arm).

        ``weights_as_args=False`` (default): the whole aligned map is
        closed over; payloads embed in the HLO as constants.
        ``weights_as_args=True``: the big weight payloads ride as jit
        ARGUMENTS via `sparse.weight_align.split_payloads` — same traced
        structure (the pattern skeleton stays concrete), but the HLO
        carries no multi-MB literals: faster serialization and compile,
        and argument buffers stay device-resident across executions
        unconditionally. Pass ``align=True`` to run
        weight_align here; ``state`` carries trained moving statistics
        (init_with_state / Solver.net_state)."""
        if align:
            aligned_params = self.weight_align(aligned_params)
        if weights_as_args:
            from caffe_escoin_tpu.sparse.weight_align import split_payloads

            graft, payloads = split_payloads(aligned_params)
            fwd = jax.jit(lambda pl, inputs: self.apply(
                graft(pl), inputs, state=state))
            return lambda inputs: fwd(payloads, inputs)
        return jax.jit(
            lambda inputs: self.apply(aligned_params, inputs, state=state))

    # ------------------------------------------------------------------
    def num_params(self, params) -> int:
        return sum(
            int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(params)
        )
