"""Gradient checkpointing (``train.remat``) in the port, on the CPU: the
gradients with each supported policy equal those without, they match the
JAX package's ``remat=True`` gradients, the selective policy keeps the
weight matmuls' outputs, and an unsupported policy raises.

Parameters come from the JAX package's `init_rag` (RAGConfig.tiny, with a
separate memory encoder so that every encoder is checkpointed) through
`bridge.load_jax_params`; inputs are numpy arrays made from a seed.
"""

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from retrieval_augmented_mds_tpu.models import retriever_generator as jrag
from retrieval_augmented_mds_tpu.train import loss as jloss
from retrieval_augmented_mds_tpu_torch.bridge import flatten_tree
from retrieval_augmented_mds_tpu_torch.models import core as tcore
from retrieval_augmented_mds_tpu_torch.models import retriever_generator as trag
from retrieval_augmented_mds_tpu_torch.train import loss as tloss
from retrieval_augmented_mds_tpu_torch.train import optimizer as toptim
from retrieval_augmented_mds_tpu_torch.train import trainer as ttrainer
from retrieval_augmented_mds_tpu_torch.utils import config as tconfig

from tests.test_torch_models import _np
from tests.test_torch_train import _train_inputs

torch.set_num_threads(1)
POLICIES = [True, "full", "dots_with_no_batch_dims_saveable"]


@pytest.fixture(scope="module")
def rag():
    from tests.test_torch_rag import _setup

    cfg, jcfg, jp, model = _setup(seed=3, memory_model_fixed=False)
    jstore, tstore, batches = _train_inputs(cfg, 3, n_batches=1)
    return cfg, jcfg, jp, model, jstore, tstore, batches[0]


def _port_grads(model, cfg, store, batch, remat):
    """(loss, {path: grad}) of the label-smoothed loss of `rag_forward`."""
    model.zero_grad(set_to_none=True)
    out, _, _ = trag.rag_forward(model, cfg, store, batch, remat=remat)
    loss = tloss.summarization_loss(out, batch["labels"], 0.1, cfg.led.pad_id)
    loss.backward()
    loss = loss.detach()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss), grads


@pytest.mark.parametrize("remat", POLICIES)
def test_remat_grads_equal_plain_grads(rag, remat):
    """Recomputing a layer repeats its arithmetic exactly: the loss and
    every gradient equal those of the run without remat."""
    cfg, _, _, model, _, tstore, (_, tb) = rag
    loss0, g0 = _port_grads(model, cfg, tstore, tb, False)
    loss1, g1 = _port_grads(model, cfg, tstore, tb, remat)
    assert loss1 == loss0
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=0, msg=n)


def test_remat_grads_match_jax(rag):
    """The port's ``remat=True`` gradients against the JAX package's
    ``remat=True`` ones: loss within rtol 1e-5, every gradient within
    1e-6 x the largest gradient of the tree (f32 summation order; the
    leaves whose gradient is zero in exact arithmetic, such as the
    attention key biases, carry roundoff of that size in both packages,
    so a per-leaf relative bound would not hold for them)."""
    cfg, jcfg, jp, model, jstore, tstore, (jb, tb) = rag

    def jloss_fn(params):
        out, _, _ = jrag.rag_forward(params, jcfg, jstore, jb, remat=True)
        return jloss.summarization_loss(out, jb["labels"], 0.1, cfg.led.pad_id)

    jl, jg = jax.value_and_grad(jloss_fn)(jp)
    loss, grads = _port_grads(model, cfg, tstore, tb, True)
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    ref = flatten_tree(jg)
    assert set(ref) == set(grads)
    atol = 1e-6 * max(float(np.abs(v).max()) for v in ref.values())
    for n, g in grads.items():
        np.testing.assert_allclose(_np(g), ref[n], rtol=0, atol=atol, err_msg=n)


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.mm.dtype):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def test_selective_policy_keeps_weight_matmuls(rag):
    """The backward's weight matmuls (aten.mm): "full" recomputes the
    forward's, "dots_with_no_batch_dims_saveable" takes them from what it
    saved, so its backward runs as many as the backward without remat."""
    cfg, _, _, model, _, tstore, (_, tb) = rag
    counts = {}
    for remat in (False, "full", "dots_with_no_batch_dims_saveable"):
        out, _, _ = trag.rag_forward(model, cfg, tstore, tb, remat=remat)
        loss = tloss.summarization_loss(out, tb["labels"], 0.1, cfg.led.pad_id)
        with _CountMatmuls() as mode:
            loss.backward()
        model.zero_grad(set_to_none=True)
        counts[remat] = mode.mm
    assert counts["dots_with_no_batch_dims_saveable"] == counts[False]
    assert counts["full"] > counts[False]


@pytest.mark.parametrize("remat", ["nothing_saveable", "dots_saveable", "bogus", 2])
def test_unsupported_remat_policy_raises(rag, remat):
    """A policy the port does not have raises, naming the ones it has,
    when the train step is made (before any step) and in the model."""
    cfg = rag[0]
    with pytest.raises(ValueError, match="dots_with_no_batch_dims_saveable"):
        ttrainer.make_train_step(cfg, toptim.build_optimizer(1e-3),
                                 tconfig.TrainHyper(), remat=remat)
    with pytest.raises(ValueError, match="not supported"):
        tcore.maybe_remat(lambda x: x, remat)


def test_remat_train_steps_equal_plain_steps(rag):
    """Two train steps with remat and the 8-bit optimizer (the capacity
    configuration) give the losses and parameters of two steps without
    remat."""
    from tests.test_torch_rag import _setup

    cfg, _, _, _, _, tstore, (_, tb) = rag
    hyper = tconfig.TrainHyper(lr=1e-3, warmup_steps=1, total_steps=10, adam_8bit=True)
    runs = []
    for remat in (False, True):
        model = _setup(seed=3, memory_model_fixed=False)[3]
        tx = toptim.build_optimizer(1e-3, 1, 10, grad_clip=0.1, state_8bit=True)
        step = ttrainer.make_train_step(cfg, tx, hyper, remat=remat)
        state = ttrainer.TrainState.create(model, tx)
        losses = [float(step(state, tstore, tb)[1]["loss"]) for _ in range(2)]
        runs.append((losses, {n: p.detach().clone() for n, p in model.named_parameters()}))
    assert runs[0][0] == runs[1][0]
    for n, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][n]), n
