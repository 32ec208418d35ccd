"""Siamese embedding training with SHARED parameters + ContrastiveLoss —
the reference's `examples/siamese/mnist_siamese_train_test.prototxt`, which
ties the two branches with `param { name: "conv1_w" }` (Caffe param
ownership, `net.cpp` param sharing). Here the tie is `LayerSpec.share_params`
(nn/net.py:45-47): the second branch's layers reuse the first branch's
parameter pytrees, so there is ONE copy of the weights and gradients sum
over both branches automatically under `jax.grad`.

Dataset: the offline digits set (see train_eval_sparse.py). Pairs are
sampled on the fly; sim=1 for same-class pairs, 0 otherwise (the
reference's `createLeveldbFromImagePairs` role).

Usage:
    python examples/siamese_digits.py --iters 400        # CPU by default
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples.train_eval_sparse import load_digits_upscaled, log  # noqa: E402


def siamese_net(feat_dim=2):
    """Two tied LeNet-ish branches -> feat/feat_p -> ContrastiveLoss.
    Mirrors mnist_siamese_train_test.prototxt's structure; branch-2 layers
    carry share_params pointing at branch 1."""
    from caffe_escoin_tpu.nn import LayerSpec

    def branch(suffix, share):
        s = suffix
        sp = (lambda n: n) if not share else (lambda n: n)
        specs = []
        for name, typ, bottoms, params in [
            ("conv1", "Convolution", (f"data{s}",),
             dict(num_output=20, kernel=5,
                  weight_filler={"type": "xavier"})),
            ("pool1", "Pooling", (f"conv1{s}",),
             dict(kernel=2, stride=2)),
            ("conv2", "Convolution", (f"pool1{s}",),
             dict(num_output=50, kernel=5,
                  weight_filler={"type": "xavier"})),
            ("pool2", "Pooling", (f"conv2{s}",), dict(kernel=2, stride=2)),
            ("ip1", "InnerProduct", (f"pool2{s}",),
             dict(num_output=500, weight_filler={"type": "xavier"})),
            ("relu1", "ReLU", (f"ip1{s}",), {}),
            ("feat", "InnerProduct", (f"relu1{s}",),
             dict(num_output=feat_dim, weight_filler={"type": "xavier"})),
        ]:
            specs.append(LayerSpec(
                f"{name}{s}", typ, bottoms, tops=(f"{name}{s}",),
                params=dict(params),
                share_params=(sp(name) if share and typ in (
                    "Convolution", "InnerProduct") else None)))
        return specs

    specs = branch("", share=False) + branch("_p", share=True)
    specs.append(LayerSpec("loss", "ContrastiveLoss",
                           ("feat", "feat_p", "sim"),
                           params=dict(margin=1.0)))
    return specs


def pair_iter(data, labels, batch, seed=0):
    rng = np.random.default_rng(seed)
    n = len(data)
    while True:
        i = rng.integers(0, n, batch)
        j = rng.integers(0, n, batch)
        # bias half the batch toward positive pairs (random pairing is ~90%
        # negative on 10 classes — the reference's pair db was 50/50)
        for b in range(0, batch, 2):
            same = np.flatnonzero(labels == labels[i[b]])
            j[b] = same[rng.integers(0, len(same))]
        yield {"data": data[i], "data_p": data[j],
               "sim": (labels[i] == labels[j]).astype(np.float32)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--base_lr", type=float, default=0.02)
    ap.add_argument("--platform", default="cpu",
                    choices=["auto", "cpu", "gpu"])
    args = ap.parse_args()

    from caffe_escoin_tpu.utils.runtime import select_platform

    select_platform(args.platform)
    import jax
    import jax.numpy as jnp

    from caffe_escoin_tpu.engine.solver import Solver
    from caffe_escoin_tpu.engine.solvers import SolverConfig
    from caffe_escoin_tpu.nn import Net

    (trd, trl), (ted, tel) = load_digits_upscaled(28, 1)
    cfg = SolverConfig(solver_type="sgd", base_lr=args.base_lr, momentum=0.9,
                       lr_policy="inv", gamma=1e-4, power=0.75,
                       weight_decay=0.0)
    net = Net(siamese_net(), phase="train")
    solver = Solver(net, cfg)
    solver.init({"data": (args.batch, 28, 28, 1),
                 "data_p": (args.batch, 28, 28, 1),
                 "sim": (args.batch,)})
    # ONE parameter copy: branch-2 layers share branch 1's pytrees
    assert "conv1_p" not in solver.params and "conv1" in solver.params
    solver.step(pair_iter(trd, trl, args.batch), args.iters, log=log)

    # embed the test set through branch 1 alone (the deployment shape of a
    # siamese model: one tower) and score: same-class pairs must sit closer
    # than different-class pairs
    feat_specs = [s for s in siamese_net()
                  if not s.name.endswith("_p") and s.name != "loss"]
    test_net = Net(feat_specs, phase="test")
    out = test_net.apply(solver.params, {"data": jnp.asarray(ted)})
    feat = np.asarray(out["feat"])
    rng = np.random.default_rng(1)
    i = rng.integers(0, len(feat), 2000)
    j = rng.integers(0, len(feat), 2000)
    d = np.linalg.norm(feat[i] - feat[j], axis=1)
    sim = tel[i] == tel[j]
    pos, neg = d[sim], d[~sim]
    thresh = 0.5
    acc = ((d < thresh) == sim).mean()
    log(f"pairs: pos mean dist {pos.mean():.3f}, neg mean dist "
        f"{neg.mean():.3f}, pair accuracy @ {thresh}: {acc:.3f}")
    assert neg.mean() > pos.mean(), "embedding did not separate classes"
    print(f"siamese: pos {pos.mean():.3f} neg {neg.mean():.3f} "
          f"pair_acc {acc:.3f}")


if __name__ == "__main__":
    main()
