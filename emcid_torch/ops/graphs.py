"""CUDA graphs that leave the hand-written attention kernels outside.

``capture(fn, inputs)`` captures ``fn``'s forward over ``inputs`` and its
backward into the inputs that require grad, and returns a ``Captured``: a
differentiable call that replays both.  Where no input requires grad, it
captures the forward alone, under no-grad.  The capture is cut at every call
routed through ``eager``, which the K1-K4 autograd functions do with their
forward and backward bodies (``ops/flash_v2.FlashAttentionV2``,
``ops/attention.ShortKVAttention``'s forward).  Such a call ends the graph
being captured, runs eagerly, and the next graph begins after it.  It is
recorded with its arguments and outputs, and each replay calls it again
in the same place, between the graphs, through the same wrappers: every
K1-K4 launch stays one eager wrapper call (``_build.LAUNCHES``/``ROUTES``
count it, a wrapper around ``flash_v2.flash_fwd`` sees it), and its
outputs are copied to the addresses the next graph reads.  All other work
of the forward and the backward, K4's chunked-recompute backward included,
replays from the graphs: one graph launch for each stretch between two
such calls.

What a replay assumes, and its callers keep: the graphs read the modules'
weights where they lay at capture (a weight updated in place is seen, a
rebound one is not, so a caller keys its captures on the modules); the
inputs are copied into static contiguous buffers of the captured shapes
and dtypes; the outputs are static buffers that the next replay
overwrites; forward and backward replay in turns.  The graphs of one
``Captured`` share one memory pool, which is theirs alone.  The backward
runs in autograd's device thread, so the capture is made in the
``relaxed`` mode, in which a capture may end in another thread than began
it.  Nothing here runs on the CPU; ``capture`` wants CUDA tensors.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

# the capture in progress (autograd's device thread reads it too)
_SESSION: Optional["_Session"] = None


def _tuple(out) -> Tuple:
    return out if isinstance(out, tuple) else (out,)


class _Eager:
    """A call made outside the graphs: replayed by calling ``fn`` again on
    the captured arguments and copying its results over the captured
    outputs."""

    __slots__ = ("fn", "args", "outs")

    def __init__(self, fn, args, outs):
        self.fn, self.args, self.outs = fn, args, outs

    def replay(self) -> None:
        for old, new in zip(self.outs, _tuple(self.fn(*self.args))):
            old.copy_(new)


class _Session:
    """The graphs and eager calls of one capture, in order."""

    def __init__(self, pool, graph_type=None):
        self.pool = pool
        self.graph_type = graph_type or torch.cuda.CUDAGraph
        self.items: List[Any] = []
        self.graph = None

    def begin(self) -> None:
        self.graph = self.graph_type()
        self.graph.capture_begin(pool=self.pool, capture_error_mode="relaxed")

    def end(self) -> None:
        graph, self.graph = self.graph, None
        graph.capture_end()
        self.items.append(graph)

    def cut(self) -> List[Any]:
        """End the open graph; the items since the last cut."""
        self.end()
        items, self.items = self.items, []
        return items

    def abort(self) -> None:
        graph, self.graph = self.graph, None
        if graph is not None:
            try:
                graph.capture_end()
            except RuntimeError:
                pass  # the capture was already invalid: it is over now


def eager(fn: Callable, *args):
    """``fn(*args)``.  Inside a capture it runs outside the graphs, between
    the graph it ends and the one that begins after it, and every replay
    calls it again there."""
    s = _SESSION
    if s is None:
        return fn(*args)
    s.end()
    out = fn(*args)
    s.items.append(_Eager(fn, args, tuple(o.detach() for o in _tuple(out))))
    s.begin()
    return out


def _play(items) -> None:
    for it in items:
        it.replay()


class _Replay(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cap, *inputs):
        ctx.cap = cap
        for s, x in zip(cap.inputs, inputs):
            s.copy_(x)
        _play(cap.fwd)
        return tuple(o.detach() for o in cap.outputs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        cap = ctx.cap
        for s, g in zip(cap.grad_outputs, grads):
            if g is None:
                s.zero_()
            else:
                s.copy_(g)
        _play(cap.bwd)
        return (None,) + tuple(None if g is None else g.detach()
                               for g in cap.grad_inputs)


class Captured:
    """A captured call: ``cap(*inputs)`` -> the outputs as a tuple,
    differentiable in the inputs that required grad at capture."""

    def __init__(self, fwd, bwd, inputs, outputs, grad_outputs,
                 grad_inputs):
        self.fwd, self.bwd = fwd, bwd
        self.inputs, self.outputs = inputs, outputs
        self.grad_outputs, self.grad_inputs = grad_outputs, grad_inputs

    @property
    def graphs(self) -> int:
        """Graph launches a forward and backward replay make."""
        return sum(not isinstance(it, _Eager) for it in self.fwd + self.bwd)

    @property
    def eager_calls(self) -> int:
        """Eager calls a forward and backward replay make."""
        return sum(isinstance(it, _Eager) for it in self.fwd + self.bwd)

    def __call__(self, *inputs) -> Tuple[torch.Tensor, ...]:
        return _Replay.apply(self, *inputs)


def _static(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` with its ``requires_grad``, as a leaf."""
    with torch.no_grad():
        s = torch.empty(x.shape, dtype=x.dtype, device=x.device).copy_(x)
    return s.requires_grad_(x.requires_grad)


def _grad_pass(outs, wrt, grad_outputs):
    """The gradients of ``outs`` (those that require grad) into ``wrt``."""
    keep = [i for i, o in enumerate(outs) if o.requires_grad]
    return torch.autograd.grad([outs[i] for i in keep], wrt,
                               [grad_outputs[i] for i in keep],
                               allow_unused=True)


def capture(fn: Callable, inputs: Sequence[torch.Tensor],
            graph_type=None) -> Captured:
    """Capture ``fn(*inputs)`` (a tensor or a tuple of tensors) and its
    backward into the inputs that require grad; where none does, the
    forward alone, under no-grad (its replay has no backward).  ``fn`` and
    its backward run twice on static copies of ``inputs``, on a side
    stream: once eagerly (library handles and workspaces are made for that
    stream, in this thread and in autograd's), then under capture.
    Only the graphs, the eager calls and the static buffers are kept, not
    ``fn``: a ``Captured`` holds no reference to the modules it runs.
    ``graph_type`` stands in for ``torch.cuda.CUDAGraph`` (tests)."""
    global _SESSION
    if _SESSION is not None:
        raise RuntimeError("a capture is already in progress")
    cuda = graph_type is None
    static = [_static(x) for x in inputs]
    wrt = [s for s in static if s.requires_grad]
    side = torch.cuda.Stream(static[0].device) if cuda else None
    if cuda:
        side.wait_stream(torch.cuda.current_stream(static[0].device))
    grad_on = torch.is_grad_enabled() and bool(wrt)
    grads = ()
    # the stream: a no-op without one
    with torch.cuda.stream(side), torch.set_grad_enabled(grad_on):
        outs = _tuple(fn(*static))
        if wrt:
            _grad_pass(outs, wrt, [torch.zeros_like(o) for o in outs])
        del outs
        if cuda:
            side.synchronize()
        sess = _Session(torch.cuda.graph_pool_handle() if cuda else None,
                        graph_type)
        _SESSION = sess
        try:
            sess.begin()
            outs = _tuple(fn(*static))
            fwd = sess.cut()
            grad_outputs, bwd = [], []
            if wrt:
                grad_outputs = [torch.zeros_like(o) for o in outs]
                sess.begin()
                grads = _grad_pass(outs, wrt, grad_outputs)
                bwd = sess.cut()
        except BaseException:
            sess.abort()
            raise
        finally:
            _SESSION = None
    if cuda:
        torch.cuda.current_stream(static[0].device).wait_stream(side)
    it = iter(grads)
    grad_inputs = [next(it) if s.requires_grad else None for s in static]
    return Captured(fwd, bwd, static, [o.detach() for o in outs],
                    grad_outputs, grad_inputs)

