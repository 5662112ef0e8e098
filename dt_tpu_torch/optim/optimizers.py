"""Optimizers with the reference's update rules (counterpart of
``dt_tpu/optim/optimizers.py``): every name of the JAX registry, the
``with_multi_precision`` wrapper and ``lamb`` (the JAX package delegates it
to optax; this module keeps its own copy of that chain).

An optimizer has ``init(params)`` and ``update(grads, state, params)``, as
the JAX package's optax transformations do, but ``update`` applies the step
to ``params`` (and to the state's tensors) in place and returns the new
state: the port keeps one copy of each tensor on the card.  ``params`` and
``grads`` are dicts by parameter name; the state is a nested dict whose
keys and leaf dtypes are the JAX package's ``to_state_dict`` of its
state: ``count`` an int (int32 in the JAX state), each per-param slot a
dict by parameter name (``mom``; ``a``, ``b``, ``c``; ``master``;
lamb's ``"0"``/``mu``, ``nu``), nadam's ``c`` a 0-d float32 numpy array
and sgld's ``mom`` a ``uint32[2]`` numpy key.  Do not swap in
``torch.optim``: its rules differ (its SGD momentum holds ``sum(g)``, not
``sum(lr * g)``, which is another rule once the LR changes).

Each rule is the JAX rule op by op, in float32 and in its order: the
gradient pipeline rescale -> clip -> ``+ wd*w`` (``optimizers.py:40-48``),
then the slots updated with a few multi-tensor (``torch._foreach_*``) ops
over all parameters; the scalars (``lr_t``, ``beta ** t``, nadam's momentum
schedule) are float32 numpy values, as the JAX package computes them in
float32 arrays.  The update is cast to each param's dtype before ``w + u``
(a bf16 ``pos_embed``), as ``optax.apply_updates`` adds it; a rule that
forms a new weight (``ftrl``, ``ftml``, ``with_multi_precision``) adds
``new - w``, not ``new``.

``lbsgd`` and ``lamb`` take a whole parameter's norm.  ``update``'s
``reduce``, when given (``parallel.zero``'s ZeRO-1 update on slices),
turns per-leaf partial sums of squares into the whole leaves' sums.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

ScalarOrSchedule = Union[float, Callable[[int], float]]
Tensors = Dict[str, torch.Tensor]
#: ``reduce(names, partial_sumsq) -> whole_sumsq``, (len(names),) float32
Reduce = Callable[[Sequence[str], torch.Tensor], torch.Tensor]
f32 = np.float32


def _lr_at(lr: ScalarOrSchedule, count: int) -> float:
    """Schedules receive the reference's 1-based ``num_update`` (mxnet
    increments the count before the lr lookup), not the 0-based count
    (``optimizers.py:32-37``); the LR as a float32 value."""
    return float(f32(lr(count + 1) if callable(lr) else lr))


def _zeros32(params: Tensors) -> Tensors:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def _in_dtypes(updates, ws):
    """The f32 updates, each cast to its param's dtype first where that is
    not f32 (a bf16 ``pos_embed``), as the JAX rule casts the update to
    ``w.dtype`` before ``w + u`` (``optimizers.py:107, 113-114``)."""
    return [u if u.dtype == w.dtype else u.to(w.dtype)
            for u, w in zip(updates, ws)]


def _as32(ts) -> List[torch.Tensor]:
    """``w.astype(f32)``: the tensor itself when it is f32 (read only)."""
    return [t.float() for t in ts]


def _like(ws, ts, dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """``ts`` copied into new tensors with the strides of ``ws`` (a
    channels-last conv weight; a gradient may come as a view in the JAX
    layout), in ``dtype`` or each ``w``'s: a multi-tensor op pairing two
    lists takes its one-launch path only when their strides agree."""
    out = [torch.empty_like(w, dtype=dtype or w.dtype) for w in ws]
    torch._foreach_copy_(out, list(ts))
    return out


def _norms(xs, names, reduce: Optional[Reduce]) -> torch.Tensor:
    """``(len(xs),)`` L2 norms of ``xs``; through ``reduce`` when each is a
    rank's slice of a whole leaf (the squared norms summed over the
    ranks)."""
    n = torch.stack([t.float() for t in torch._foreach_norm(xs)])
    return n if reduce is None else reduce(names, n * n).sqrt()


class _Rule:
    """A rule of the JAX registry: its hyperparameters, the gradient
    pipeline and the in-place apply.  ``_slots`` names its f32 per-param
    slots; ``_step`` moves them and returns the f32 updates."""

    _slots: tuple = ()
    _wd_in_grad = True  # wd folded into the gradient (coupled)

    def __init__(self, learning_rate: ScalarOrSchedule = 0.01,
                 weight_decay: float = 0.0, rescale_grad: float = 1.0,
                 clip_gradient: Optional[float] = None):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient

    def init(self, params: Tensors) -> dict:
        return {"count": 0, **{s: _zeros32(params) for s in self._slots}}

    def _grads(self, grads, names, ws, wd: float):
        """``_preprocess`` (``optimizers.py:40-48``) on new f32 tensors
        laid out as the params; the caller's gradients are never
        written."""
        g = _like(ws, [grads[k] for k in names], torch.float32)
        if self.rescale_grad != 1.0:  # x * 1.0 is x
            torch._foreach_mul_(g, self.rescale_grad)
        if self.clip_gradient is not None:
            torch._foreach_clamp_min_(g, -self.clip_gradient)
            torch._foreach_clamp_max_(g, self.clip_gradient)
        if wd:
            torch._foreach_add_(g, torch._foreach_mul(_as32(ws), wd))
        return g

    @torch.no_grad()
    def update(self, grads: Tensors, state: dict, params: Tensors,
               reduce: Optional[Reduce] = None) -> dict:
        names = list(params)
        ws = [params[k] for k in names]
        g = self._grads(grads, names, ws,
                        self.weight_decay if self._wd_in_grad else 0.0)
        new = dict(state)
        slots = [[state[s][k] for k in names] for s in self._slots]
        upd = self._step(names, ws, g, slots, new, reduce)
        torch._foreach_add_(ws, _in_dtypes(upd, ws))
        new["count"] = state["count"] + 1
        return new

    def _step(self, names, ws, g, slots, state, reduce):
        raise NotImplementedError


def _ema_(m, g, beta: float) -> None:
    """``m = beta*m + (1-beta)*g`` in place."""
    torch._foreach_mul_(m, beta)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - beta))


def _ema_sq_(v, g, beta: float) -> None:
    """``v = beta*v + (1-beta)*g*g`` in place (``(1-beta)*g`` first)."""
    sq = torch._foreach_mul(g, 1 - beta)
    torch._foreach_mul_(sq, g)
    torch._foreach_mul_(v, beta)
    torch._foreach_add_(v, sq)


class SGD(_Rule):
    """SGD with momentum, ``mom = momentum*mom - lr*(g + wd*w); w += mom``
    (``optimizers.py:90-118``); without momentum ``w += -lr*g`` and the
    state is ``{"count"}``."""

    def __init__(self, learning_rate: ScalarOrSchedule = 0.01,
                 momentum: float = 0.0, weight_decay: float = 0.0,
                 rescale_grad: float = 1.0,
                 clip_gradient: Optional[float] = None):
        super().__init__(learning_rate, weight_decay, rescale_grad,
                         clip_gradient)
        self.momentum = momentum
        self._slots = ("mom",) if momentum != 0.0 else ()

    def _step(self, names, ws, g, slots, state, reduce):
        lr = _lr_at(self.learning_rate, state["count"])
        if not slots:
            return torch._foreach_mul(g, -lr)
        mom, = slots
        torch._foreach_mul_(mom, self.momentum)
        torch._foreach_sub_(mom, torch._foreach_mul(g, lr))
        return mom


class NAG(_Rule):
    """Nesterov SGD, ``mom = momentum*mom + g; w -= lr*(g + momentum*mom)``
    (``optimizers.py:121-140``)."""

    _slots = ("mom",)

    def __init__(self, learning_rate=0.01, momentum=0.9, weight_decay=0.0,
                 rescale_grad=1.0, clip_gradient=None):
        super().__init__(learning_rate, weight_decay, rescale_grad,
                         clip_gradient)
        self.momentum = momentum

    def _step(self, names, ws, g, slots, state, reduce):
        lr = _lr_at(self.learning_rate, state["count"])
        mom, = slots
        torch._foreach_mul_(mom, self.momentum)
        torch._foreach_add_(mom, g)
        u = torch._foreach_mul(mom, self.momentum)
        torch._foreach_add_(u, g)
        torch._foreach_mul_(u, -lr)
        return u


class Adam(_Rule):
    """Adam with bias correction and coupled wd (``optimizers.py:143-
    169``): ``lr_t = lr*sqrt(1-b2^t)/(1-b1^t)``, ``u = -lr_t*m/(sqrt(v) +
    eps)``."""

    _slots = ("a", "b")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.0, rescale_grad=1.0,
                 clip_gradient=None):
        super().__init__(learning_rate, weight_decay, rescale_grad,
                         clip_gradient)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _step(self, names, ws, g, slots, state, reduce):
        t = f32(state["count"] + 1)
        lr = f32(_lr_at(self.learning_rate, state["count"]))
        lr_t = lr * np.sqrt(f32(1) - f32(self.beta2) ** t) / \
            (f32(1) - f32(self.beta1) ** t)
        m, v = slots
        _ema_(m, g, self.beta1)
        _ema_sq_(v, g, self.beta2)
        den = torch._foreach_sqrt(v)
        torch._foreach_add_(den, self.epsilon)
        u = torch._foreach_mul(m, float(-lr_t))
        torch._foreach_div_(u, den)
        return u


class AdaGrad(_Rule):
    """AdaGrad (``optimizers.py:172-194``): ``hist += g*g`` with wd kept
    out of the accumulator, ``w -= lr*(g/sqrt(hist + eps) + wd*w)``."""

    _slots = ("mom",)
    _wd_in_grad = False

    def __init__(self, learning_rate=0.01, epsilon=1e-7, weight_decay=0.0,
                 rescale_grad=1.0, clip_gradient=None):
        super().__init__(learning_rate, weight_decay, rescale_grad,
                         clip_gradient)
        self.epsilon = epsilon

    def _step(self, names, ws, g, slots, state, reduce):
        lr = _lr_at(self.learning_rate, state["count"])
        h, = slots
        torch._foreach_add_(h, torch._foreach_mul(g, g))
        den = torch._foreach_add(h, self.epsilon)
        torch._foreach_sqrt_(den)
        u = torch._foreach_div(g, den)
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(_as32(ws),
                                                      self.weight_decay))
        torch._foreach_mul_(u, -lr)
        return u


class RMSProp(_Rule):
    """RMSProp, plain and centered (``optimizers.py:197-237``); with
    ``momentum=0`` the plain rule leaves its ``b`` slot as it was."""

    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.0,
                 epsilon=1e-8, centered=False, weight_decay=0.0,
                 rescale_grad=1.0, clip_gradient=None):
        super().__init__(learning_rate, weight_decay, rescale_grad,
                         clip_gradient)
        self.rho, self.momentum, self.epsilon = rho, momentum, epsilon
        self.centered = centered
        self._slots = ("a", "b", "c") if centered else ("a", "b")

    def _step(self, names, ws, g, slots, state, reduce):
        lr = _lr_at(self.learning_rate, state["count"])
        n = slots[0]
        _ema_sq_(n, g, self.rho)
        if self.centered:
            _, gavg, d = slots
            _ema_(gavg, g, self.rho)
            den = torch._foreach_sub(n, torch._foreach_mul(gavg, gavg))
        else:
            den = list(n)
        den = torch._foreach_add(den, self.epsilon)
        torch._foreach_sqrt_(den)
        step = torch._foreach_mul(g, lr)
        torch._foreach_div_(step, den)
        if self.centered:
            torch._foreach_mul_(d, self.momentum)
            torch._foreach_sub_(d, step)
            return d
        if self.momentum:
            m = slots[1]
            torch._foreach_mul_(m, self.momentum)
            torch._foreach_sub_(m, step)
            return m
        return torch._foreach_neg(step)


class AdaDelta(_Rule):
    """AdaDelta, no LR (``optimizers.py:240-259``); the count still
    moves."""

    _slots = ("a", "b")

    def __init__(self, rho=0.9, epsilon=1e-5, weight_decay=0.0,
                 rescale_grad=1.0, clip_gradient=None):
        super().__init__(None, weight_decay, rescale_grad, clip_gradient)
        self.rho, self.epsilon = rho, epsilon

    def _step(self, names, ws, g, slots, state, reduce):
        acc_g, acc_d = slots
        _ema_sq_(acc_g, g, self.rho)
        num = torch._foreach_add(acc_d, self.epsilon)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(acc_g, self.epsilon)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(num, den)
        d = torch._foreach_mul(num, g)
        _ema_sq_(acc_d, d, self.rho)
        return torch._foreach_neg(d)


class Ftrl(_Rule):
    """FTRL-proximal (``optimizers.py:262-291``): the new weight is the
    soft-threshold of ``z``; the update is ``new_w - w``."""

    _slots = ("a", "b")
    _wd_in_grad = False

    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1.0,
                 weight_decay=0.0, rescale_grad=1.0, clip_gradient=None):
        super().__init__(learning_rate, weight_decay, rescale_grad,
                         clip_gradient)
        self.lamda1, self.beta = lamda1, beta

    def _step(self, names, ws, g, slots, state, reduce):
        lr = _lr_at(self.learning_rate, state["count"])
        z, n = slots
        w32 = _as32(ws)
        gg = torch._foreach_mul(g, g)
        t = torch._foreach_add(n, gg)
        torch._foreach_sqrt_(t)
        torch._foreach_sub_(t, torch._foreach_sqrt(n))
        torch._foreach_div_(t, lr)
        torch._foreach_mul_(t, w32)
        torch._foreach_add_(z, g)
        torch._foreach_sub_(z, t)
        torch._foreach_add_(n, gg)
        den = torch._foreach_sqrt(n)
        torch._foreach_add_(den, self.beta)
        torch._foreach_div_(den, lr)
        torch._foreach_add_(den, self.weight_decay)
        upd = []
        for zi, di, wi in zip(z, den, w32):
            new_w = torch.where(zi.abs() > self.lamda1,
                                -(zi - zi.sign() * self.lamda1) / di,
                                torch.zeros((), dtype=torch.float32,
                                            device=zi.device))
            upd.append(new_w - wi)
        return upd


class Adamax(_Rule):
    """Adamax (``optimizers.py:294-317``): ``v = max(b2*v, |g|)``,
    ``u = -lr/(1-b1^t) * m / (v + 1e-8)``."""

    _slots = ("a", "b")

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 weight_decay=0.0, rescale_grad=1.0, clip_gradient=None):
        super().__init__(learning_rate, weight_decay, rescale_grad,
                         clip_gradient)
        self.beta1, self.beta2 = beta1, beta2

    def _step(self, names, ws, g, slots, state, reduce):
        t = f32(state["count"] + 1)
        lr_t = f32(_lr_at(self.learning_rate, state["count"])) / \
            (f32(1) - f32(self.beta1) ** t)
        m, v = slots
        _ema_(m, g, self.beta1)
        torch._foreach_mul_(v, self.beta2)
        torch._foreach_maximum_(v, torch._foreach_abs(g))
        u = torch._foreach_mul(m, float(-lr_t))
        torch._foreach_div_(u, torch._foreach_add(v, 1e-8))
        return u


class Nadam(_Rule):
    """Nadam, Dozat's momentum-cache schedule (``optimizers.py:320-355``);
    ``c``, the running product of the schedule, is a 0-d float32 numpy
    value on the host."""

    _slots = ("a", "b")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, weight_decay=0.0,
                 rescale_grad=1.0, clip_gradient=None):
        super().__init__(learning_rate, weight_decay, rescale_grad,
                         clip_gradient)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay

    def init(self, params):
        return {**super().init(params), "c": np.ones((), np.float32)}

    def _step(self, names, ws, g, slots, state, reduce):
        t = f32(state["count"] + 1)
        lr = f32(_lr_at(self.learning_rate, state["count"]))
        b1, sd = f32(self.beta1), f32(self.schedule_decay)
        m_t = b1 * (f32(1) - f32(0.5) * f32(0.96) ** (t * sd))
        m_t1 = b1 * (f32(1) - f32(0.5) * f32(0.96) ** ((t + f32(1)) * sd))
        m_prod = f32(state["c"]) * m_t
        m_prod1 = m_prod * m_t1
        m, v = slots
        g_hat = torch._foreach_div(g, float(f32(1) - m_prod))
        _ema_(m, g, self.beta1)
        m_hat = torch._foreach_div(m, float(f32(1) - m_prod1))
        _ema_sq_(v, g, self.beta2)
        v_hat = torch._foreach_div(v, float(f32(1) - f32(self.beta2) ** t))
        torch._foreach_mul_(g_hat, float(f32(1) - m_t))
        torch._foreach_mul_(m_hat, float(m_t1))
        torch._foreach_add_(g_hat, m_hat)
        torch._foreach_mul_(g_hat, float(-lr))
        torch._foreach_sqrt_(v_hat)
        torch._foreach_add_(v_hat, self.epsilon)
        torch._foreach_div_(g_hat, v_hat)
        state["c"] = np.asarray(m_prod, np.float32)
        return g_hat


class Signum(_Rule):
    """signSGD / Signum (``optimizers.py:358-385``): ``u = -lr*(sign(m) +
    wd_lh*w)``; ``momentum=0`` (the ``signsgd`` name) keeps ``m = g``."""

    _slots = ("mom",)

    def __init__(self, learning_rate=0.01, momentum=0.9, weight_decay=0.0,
                 wd_lh=0.0, rescale_grad=1.0, clip_gradient=None):
        super().__init__(learning_rate, weight_decay, rescale_grad,
                         clip_gradient)
        self.momentum, self.wd_lh = momentum, wd_lh

    def _step(self, names, ws, g, slots, state, reduce):
        lr = _lr_at(self.learning_rate, state["count"])
        m, = slots
        if self.momentum:
            _ema_(m, g, self.momentum)
        else:
            torch._foreach_copy_(m, g)
        u = torch._foreach_sign(m)
        if self.wd_lh:
            torch._foreach_add_(u, torch._foreach_mul(_as32(ws), self.wd_lh))
        torch._foreach_mul_(u, -lr)
        return u


class FTML(_Rule):
    """FTML, Follow The Moving Leader (``optimizers.py:388-416``): the new
    weight ``-z/d_t``; the update is ``new_w - w``."""

    _slots = ("a", "b", "c")

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.0, rescale_grad=1.0,
                 clip_gradient=None):
        super().__init__(learning_rate, weight_decay, rescale_grad,
                         clip_gradient)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _step(self, names, ws, g, slots, state, reduce):
        t = f32(state["count"] + 1)
        lr = f32(_lr_at(self.learning_rate, state["count"]))
        d, v, z = slots
        w32 = _as32(ws)
        _ema_sq_(v, g, self.beta2)
        d_t = torch._foreach_div(v, float(f32(1) - f32(self.beta2) ** t))
        torch._foreach_sqrt_(d_t)
        torch._foreach_add_(d_t, self.epsilon)
        torch._foreach_mul_(d_t, float((f32(1) - f32(self.beta1) ** t) / lr))
        sigma = torch._foreach_mul(d, self.beta1)
        torch._foreach_sub_(sigma, d_t)  # -(d_t - beta1*d)
        _ema_(z, g, self.beta1)
        torch._foreach_add_(z, torch._foreach_mul(sigma, w32))
        torch._foreach_copy_(d, d_t)
        u = torch._foreach_div(torch._foreach_neg(z), d_t)
        torch._foreach_sub_(u, w32)
        return u


# -- sgld's key: JAX's threefry2x32 split, in numpy --------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) of JAX's default PRNG, on
    uint32 numpy arrays."""
    with np.errstate(over="ignore"):
        k0, k1 = np.uint32(k0), np.uint32(k1)
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def split_key(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` of a raw ``uint32[2]`` key (the
    partitionable threefry the JAX package runs with): ``(num, 2)``
    uint32."""
    b1, b2 = _threefry2x32(key[0], key[1], np.zeros(num, np.uint32),
                           np.arange(num, dtype=np.uint32))
    return np.stack([b1, b2], axis=1)


class SGLD(_Rule):
    """Stochastic Gradient Langevin Dynamics (``optimizers.py:419-442``):
    ``u = -lr/2*g + N(0, lr)``.  The state's ``mom`` is the JAX key, a
    ``uint32[2]`` numpy array split each step as ``jax.random.split``
    splits it (the key stream equals the JAX package's).  The noise cannot
    be ``jax.random.normal``'s: each param's draw comes from a
    ``torch.Generator`` on its device seeded with its subkey's 64 bits, so
    the noise stream differs from the JAX package's (as every port RNG
    stream does) while its law is the same."""

    def __init__(self, learning_rate=0.01, weight_decay=0.0,
                 rescale_grad=1.0, clip_gradient=None, seed: int = 0):
        super().__init__(learning_rate, weight_decay, rescale_grad,
                         clip_gradient)
        self.seed = seed

    def init(self, params):
        # jax.random.PRNGKey(seed): (0, seed) for a seed below 2**32
        return {"count": 0, "mom": np.array(
            [(self.seed >> 32) & 0xFFFFFFFF, self.seed & 0xFFFFFFFF],
            np.uint32)}

    def _step(self, names, ws, g, slots, state, reduce):
        lr = f32(_lr_at(self.learning_rate, state["count"]))
        key, sub = split_key(state["mom"])
        keys = split_key(sub, len(ws))
        scale = float(np.sqrt(lr))
        torch._foreach_mul_(g, float(-lr / f32(2)))
        for gi, w, k in zip(g, ws, keys):
            gen = torch.Generator(device=w.device)
            gen.manual_seed((int(k[0]) << 32) | int(k[1]))
            noise = torch.randn(w.shape, generator=gen, device=w.device,
                                dtype=torch.float32)
            gi.add_(noise.mul_(scale))
        state["mom"] = key
        return g


class DCASGD(_Rule):
    """Delay-compensated ASGD (``optimizers.py:445-471``): ``g + lamda*g*g*
    (w - w_prev)``; the ``b`` slot starts as an f32 copy of the params."""

    _slots = ("a", "b")

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04,
                 weight_decay=0.0, rescale_grad=1.0, clip_gradient=None):
        super().__init__(learning_rate, weight_decay, rescale_grad,
                         clip_gradient)
        self.momentum, self.lamda = momentum, lamda

    def init(self, params):
        return {"count": 0, "a": _zeros32(params),
                "b": {k: p.detach().to(torch.float32, copy=True)
                      for k, p in params.items()}}

    def _step(self, names, ws, g, slots, state, reduce):
        lr = _lr_at(self.learning_rate, state["count"])
        m, wp = slots
        w32 = _as32(ws)
        comp = torch._foreach_mul(g, self.lamda)
        torch._foreach_mul_(comp, g)
        torch._foreach_mul_(comp, torch._foreach_sub(w32, wp))
        torch._foreach_add_(comp, g)
        torch._foreach_mul_(m, self.momentum)
        torch._foreach_sub_(m, torch._foreach_mul(comp, lr))
        torch._foreach_copy_(wp, w32)
        return m


class LBSGD(_Rule):
    """Large-batch SGD with the LARS ratio ``eta*|w|/(|g| + wd*|w|)``
    (``optimizers.py:474-507``): the gradient is clipped before the norms
    and takes its weight decay after them."""

    _slots = ("mom",)
    _wd_in_grad = False

    def __init__(self, learning_rate=0.01, momentum=0.9, weight_decay=0.0,
                 eta=0.001, rescale_grad=1.0, clip_gradient=None):
        super().__init__(learning_rate, weight_decay, rescale_grad,
                         clip_gradient)
        self.momentum, self.eta = momentum, eta

    def _step(self, names, ws, g, slots, state, reduce):
        lr = _lr_at(self.learning_rate, state["count"])
        m, = slots
        w32 = _as32(ws)
        k = len(ws)
        norms = _norms(w32 + g, list(names) * 2, reduce)
        wn, gn = norms[:k], norms[k:]
        wd = self.weight_decay
        lars = torch.where((wn > 0) & (gn > 0),
                           self.eta * wn / (gn + wd * wn + 1e-9),
                           torch.ones_like(wn))
        if wd:
            torch._foreach_add_(g, torch._foreach_mul(w32, wd))
        torch._foreach_mul_(g, list((lars * lr).unbind()))
        torch._foreach_mul_(m, self.momentum)
        torch._foreach_sub_(m, g)
        return m


class Lamb:
    """LAMB, the port's copy of ``optax.lamb`` as the JAX package calls it
    (``optimizers.py:510-520``; optax 0.2.6's chain ``scale_by_adam(
    eps_root=0)``, ``add_decayed_weights``, ``scale_by_trust_ratio``,
    ``scale_by_learning_rate``).  Its state is the chain's:
    ``{"0": {"count", "mu", "nu"}, "1": {}, "2": {}, "3": {}}``, ``"3"``
    ``{"count"}`` under a schedule, which gets optax's 0-based count; the
    moments have the params' dtypes, the rule takes no gradient pipeline
    and runs in each param's dtype as optax does (float32 for float32
    params)."""

    def __init__(self, learning_rate: ScalarOrSchedule = 0.001,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-6, weight_decay: float = 0.0):
        self.learning_rate = learning_rate
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.weight_decay = weight_decay

    def init(self, params: Tensors) -> dict:
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        return {"0": {"count": 0, "mu": zeros,
                      "nu": {k: torch.zeros_like(p)
                             for k, p in params.items()}},
                "1": {}, "2": {},
                "3": {"count": 0} if callable(self.learning_rate) else {}}

    @torch.no_grad()
    def update(self, grads: Tensors, state: dict, params: Tensors,
               reduce: Optional[Reduce] = None) -> dict:
        names = list(params)
        ws = [params[k] for k in names]
        adam = state["0"]
        c = f32(adam["count"] + 1)
        b1, b2 = self.beta1, self.beta2
        groups = _dtype_groups(ws)
        u: list = [None] * len(ws)
        for dt, idx in groups:
            def s(x, dt=dt):  # a Python scalar in the leaves' dtype
                return _scalar(x, dt)
            g = _like([ws[i] for i in idx], [grads[names[i]] for i in idx])
            mu = [adam["mu"][names[i]] for i in idx]
            nu = [adam["nu"][names[i]] for i in idx]
            torch._foreach_mul_(mu, s(b1))
            torch._foreach_add_(mu, torch._foreach_mul(g, s(1 - b1)))
            sq = torch._foreach_mul(g, g)
            torch._foreach_mul_(sq, s(1 - b2))
            torch._foreach_mul_(nu, s(b2))
            torch._foreach_add_(nu, sq)
            ud = torch._foreach_div(mu, s(f32(1) - f32(b1) ** c))
            den = torch._foreach_div(nu, s(f32(1) - f32(b2) ** c))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, s(self.epsilon))
            torch._foreach_div_(ud, den)
            if self.weight_decay:
                torch._foreach_add_(ud, torch._foreach_mul(
                    [ws[i] for i in idx], s(self.weight_decay)))
            for i, t in zip(idx, ud):
                u[i] = t
        k = len(ws)
        norms = _norms(list(ws) + u, list(names) * 2, reduce)
        new = {"0": {"count": adam["count"] + 1, "mu": adam["mu"],
                     "nu": adam["nu"]}, "1": {}, "2": {}, "3": {}}
        if callable(self.learning_rate):
            lr = -f32(self.learning_rate(state["3"]["count"]))
            new["3"] = {"count": state["3"]["count"] + 1}
        else:
            lr = -self.learning_rate
        for dt, idx in groups:
            sel = torch.tensor(idx, device=norms.device)
            pn, un = norms[sel].to(dt), norms[sel + k].to(dt)
            ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                                pn / un)
            ud = [u[i] for i in idx]
            torch._foreach_mul_(ud, list(ratio.unbind()))
            torch._foreach_mul_(ud, _scalar(lr, dt))
            torch._foreach_add_([ws[i] for i in idx], ud)
        return new


def _dtype_groups(ts) -> list:
    """``[(dtype, [index, ...]), ...]`` of ``ts`` by dtype, in order."""
    groups: Dict[torch.dtype, list] = {}
    for i, t in enumerate(ts):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.items())


def _scalar(x, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as JAX makes a Python scalar weakly typed
    to the array it meets (a bf16 leaf's scalars are bf16)."""
    return float(torch.tensor(float(x), dtype=torch.float64).to(dtype))


class MultiPrecision:
    """f32 master weights for the params (``optimizers.py:524-560``): the
    inner optimizer runs on the masters in place; each param then gets
    ``w + (master.astype(w.dtype) - w)``, in ``w``'s dtype, as
    ``optax.apply_updates`` adds the JAX wrapper's update (for an f32 param
    not always ``master`` bit for bit).  State ``{"master", "inner"}``.
    The masters are copies taken by :meth:`init`: weights loaded into the
    params in place afterwards need a new state (``TrainState.create``),
    as do dcasgd's previous weights and svrg's snapshot."""

    def __init__(self, inner):
        self.inner = inner

    @property
    def learning_rate(self):
        return getattr(self.inner, "learning_rate", None)

    def init(self, params: Tensors) -> dict:
        master = {k: p.detach().to(torch.float32, copy=True)
                  for k, p in params.items()}
        return {"master": master, "inner": self.inner.init(master)}

    @torch.no_grad()
    def update(self, grads: Tensors, state: dict, params: Tensors,
               reduce: Optional[Reduce] = None) -> dict:
        names = list(params)
        master = state["master"]
        inner = self.inner.update({k: grads[k].float() for k in names},
                                  state["inner"],
                                  {k: master[k] for k in names}, reduce)
        ws = [params[k] for k in names]
        u = torch._foreach_sub(_in_dtypes([master[k] for k in names], ws),
                               ws)
        torch._foreach_add_(ws, u)
        return {"master": master, "inner": inner}


# ---------------------------------------------------------------------------
# the names (``optimizers.py:563-599``)
# ---------------------------------------------------------------------------


def sgd(learning_rate: ScalarOrSchedule = 0.01, momentum: float = 0.0,
        weight_decay: float = 0.0, rescale_grad: float = 1.0,
        clip_gradient: Optional[float] = None) -> SGD:
    return SGD(learning_rate, momentum, weight_decay, rescale_grad,
               clip_gradient)


def nag(learning_rate=0.01, momentum=0.9, weight_decay=0.0,
        rescale_grad=1.0, clip_gradient=None) -> NAG:
    return NAG(learning_rate, momentum, weight_decay, rescale_grad,
               clip_gradient)


def adam(learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
         weight_decay=0.0, rescale_grad=1.0, clip_gradient=None) -> Adam:
    return Adam(learning_rate, beta1, beta2, epsilon, weight_decay,
                rescale_grad, clip_gradient)


def adagrad(learning_rate=0.01, epsilon=1e-7, weight_decay=0.0,
            rescale_grad=1.0, clip_gradient=None) -> AdaGrad:
    return AdaGrad(learning_rate, epsilon, weight_decay, rescale_grad,
                   clip_gradient)


def rmsprop(learning_rate=0.001, rho=0.9, momentum=0.0, epsilon=1e-8,
            centered=False, weight_decay=0.0, rescale_grad=1.0,
            clip_gradient=None) -> RMSProp:
    return RMSProp(learning_rate, rho, momentum, epsilon, centered,
                   weight_decay, rescale_grad, clip_gradient)


def adadelta(rho=0.9, epsilon=1e-5, weight_decay=0.0, rescale_grad=1.0,
             clip_gradient=None) -> AdaDelta:
    return AdaDelta(rho, epsilon, weight_decay, rescale_grad, clip_gradient)


def ftrl(learning_rate=0.1, lamda1=0.01, beta=1.0, weight_decay=0.0,
         rescale_grad=1.0, clip_gradient=None) -> Ftrl:
    return Ftrl(learning_rate, lamda1, beta, weight_decay, rescale_grad,
                clip_gradient)


def adamax(learning_rate=0.002, beta1=0.9, beta2=0.999, weight_decay=0.0,
           rescale_grad=1.0, clip_gradient=None) -> Adamax:
    return Adamax(learning_rate, beta1, beta2, weight_decay, rescale_grad,
                  clip_gradient)


def nadam(learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
          schedule_decay=0.004, weight_decay=0.0, rescale_grad=1.0,
          clip_gradient=None) -> Nadam:
    return Nadam(learning_rate, beta1, beta2, epsilon, schedule_decay,
                 weight_decay, rescale_grad, clip_gradient)


def signum(learning_rate=0.01, momentum=0.9, weight_decay=0.0, wd_lh=0.0,
           rescale_grad=1.0, clip_gradient=None) -> Signum:
    return Signum(learning_rate, momentum, weight_decay, wd_lh, rescale_grad,
                  clip_gradient)


def ftml(learning_rate=0.0025, beta1=0.6, beta2=0.999, epsilon=1e-8,
         weight_decay=0.0, rescale_grad=1.0, clip_gradient=None) -> FTML:
    return FTML(learning_rate, beta1, beta2, epsilon, weight_decay,
                rescale_grad, clip_gradient)


def sgld(learning_rate=0.01, weight_decay=0.0, rescale_grad=1.0,
         clip_gradient=None, seed: int = 0) -> SGLD:
    return SGLD(learning_rate, weight_decay, rescale_grad, clip_gradient,
                seed)


def dcasgd(learning_rate=0.01, momentum=0.0, lamda=0.04, weight_decay=0.0,
           rescale_grad=1.0, clip_gradient=None) -> DCASGD:
    return DCASGD(learning_rate, momentum, lamda, weight_decay, rescale_grad,
                  clip_gradient)


def lbsgd(learning_rate=0.01, momentum=0.9, weight_decay=0.0, eta=0.001,
          rescale_grad=1.0, clip_gradient=None) -> LBSGD:
    return LBSGD(learning_rate, momentum, weight_decay, eta, rescale_grad,
                 clip_gradient)


def lamb(learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-6,
         weight_decay=0.0) -> Lamb:
    return Lamb(learning_rate, beta1, beta2, epsilon, weight_decay)


def with_multi_precision(inner) -> MultiPrecision:
    """Keep f32 master weights for the params (the reference's MP updates,
    ``mp_sgd_update``; the servers' master copies)."""
    return MultiPrecision(inner)


_REGISTRY: Dict[str, Callable] = {
    "sgd": sgd,
    "nag": nag,
    "adam": adam,
    "adagrad": adagrad,
    "rmsprop": rmsprop,
    "adadelta": adadelta,
    "ftrl": ftrl,
    "adamax": adamax,
    "nadam": nadam,
    "signum": signum,
    "signsgd": lambda learning_rate=0.01, **kw: signum(learning_rate,
                                                       momentum=0.0, **kw),
    "ftml": ftml,
    "sgld": sgld,
    "dcasgd": dcasgd,
    "lbsgd": lbsgd,
    "lamb": lamb,
}


def register(name: str, factory: Callable) -> Callable:
    """Register a custom optimizer under ``name`` (reference
    ``Optimizer.register``)."""
    _REGISTRY[name.lower()] = factory
    return factory


def create(name: str, multi_precision: bool = False, **kwargs):
    """Create an optimizer by name (reference ``mx.optimizer.create``);
    ``multi_precision`` wraps it in :func:`with_multi_precision`."""
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(
            f"unknown optimizer {name!r}; registered: {sorted(_REGISTRY)}")
    tx = _REGISTRY[key](**kwargs)
    return with_multi_precision(tx) if multi_precision else tx
