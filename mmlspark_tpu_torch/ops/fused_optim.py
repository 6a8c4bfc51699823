"""The trainer's optimizer update and anomaly quarantine as one pass.

:func:`optimizer_update` advances every parameter tensor and its optimizer
moments by one optax update — ``adam`` (b1 0.9, b2 0.999, eps 1e-8,
bias-corrected), ``adamw`` (plus the decoupled ``weight_decay * p``),
``sgd`` and ``momentum`` (a trace) — in place, unless the step is
quarantined (``bad``), in which case every parameter and moment keeps its
old value, as the trainer's ``torch.where(bad, old, new)`` selects.

There is no TPU kernel behind it: in the reference, XLA fuses this update
into the jitted training step. On a CUDA tensor the update is one
multi-tensor launch of ``csrc/fused_optim.cu`` (every parameter tensor in
one grid, up to :data:`MAX_TENSORS` a launch), bit-equal in f32 to
:func:`optimizer_update_reference`, the plain version, on the same card.
On a CPU tensor it runs that plain version: the trainer's eager update,
a dozen elementwise passes a tensor. The per-step scalars — ``-lr``, the
bias corrections ``1 - b^count`` and ``bad`` — stay torch ops on the
device; the kernel reads them through pointers.
"""

from __future__ import annotations

import ctypes

import torch

#: launches of the kernel in this process — added to where the wrapper
#: launches it and nowhere else
launches = 0
COUNTERS = ("launches",)

KINDS = ("adam", "adamw", "sgd", "momentum")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
#: parameter tensors one launch covers (the kernel's table capacity)
MAX_TENSORS = 128


def moment_names(kind: str) -> tuple:
    """The per-parameter moment lists an optimizer kind keeps."""
    if kind in ("adam", "adamw"):
        return ("mu", "nu")
    if kind == "momentum":
        return ("trace",)
    return ()


def fused_update_route(t: torch.Tensor) -> str:
    """``"cuda"``, the kernel, for a CUDA tensor; ``"plain"``, the plain
    version, for a CPU tensor; anything else raises."""
    if t.device.type == "cuda":
        return "cuda"
    if t.device.type == "cpu":
        return "plain"
    raise ValueError(
        f"the optimizer update runs on cuda (the kernel) or cpu (its plain "
        f"version), got {t.device}"
    )


def optimizer_update(kind: str, params: list, grads: list, state: dict,
                     lr, bad, *, weight_decay: float = 0.0,
                     momentum: float = 0.9) -> None:
    """One optax update of ``params`` from ``grads``, in place.

    ``state`` is ``{"count": 0-d int32, <moment>: [tensor a param]}``
    (:func:`moment_names`); ``lr`` the 0-d f32 learning rate read at the
    count before its increment; ``bad`` a 0-d bool. Every parameter, every
    moment and the count advance, or, where ``bad``, all keep their old
    values."""
    if kind not in KINDS:
        raise ValueError(f"unknown optimizer '{kind}'")
    count = state["count"]
    step_size = -lr
    new_count = count + 1
    c1 = c2 = None
    if kind in ("adam", "adamw"):
        c1 = 1 - torch.pow(ADAM_B1, new_count)
        c2 = 1 - torch.pow(ADAM_B2, new_count)
    # made before the update: an allocation that fails leaves every
    # parameter, moment and the count as they were
    kept_count = torch.where(bad, count, new_count)
    moments = [state[name] for name in moment_names(kind)]
    args = (kind, params, grads, moments, step_size, c1, c2, bad)
    kw = dict(weight_decay=weight_decay, momentum=momentum)
    if fused_update_route(params[0]) == "plain":
        optimizer_update_reference(*args, **kw)
    else:
        _launch(*args, **kw)
    count.copy_(kept_count)


def optimizer_update_reference(kind, params, grads, moments, step_size, c1,
                               c2, bad, *, weight_decay: float = 0.0,
                               momentum: float = 0.9) -> None:
    """The plain version: optax's update as eager tensor ops (new
    parameters and moments), then the quarantine's select, copied in
    place. ``moments`` holds the kind's moment lists in
    :func:`moment_names` order; ``c1``/``c2`` are adam's bias
    corrections."""
    if kind in ("adam", "adamw"):
        b1, b2, eps = ADAM_B1, ADAM_B2, ADAM_EPS
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, moments[0])]
        nu = [(1 - b2) * g * g + b2 * n for g, n in zip(grads, moments[1])]
        updates = [(m / c1) / (torch.sqrt(n / c2) + eps)
                   for m, n in zip(mu, nu)]
        if kind == "adamw":
            updates = [u + weight_decay * p
                       for u, p in zip(updates, params)]
        new_moments = [mu, nu]
    elif kind == "momentum":
        trace = [g + momentum * t for g, t in zip(grads, moments[0])]
        updates = trace
        new_moments = [trace]
    else:
        updates = grads
        new_moments = []
    new_params = [p + step_size * u for p, u in zip(params, updates)]
    for old, new in zip([params, *moments], [new_params, *new_moments]):
        for o, n in zip(old, new):
            o.copy_(torch.where(bad, o, n))


def _check(kind, params, grads, moments, scalars) -> None:
    """What the kernel takes: f32 contiguous tensors on one CUDA device,
    each gradient and moment shaped as its parameter; f32 scalars and a
    bool ``bad``, 0-d on that device."""
    dev = params[0].device
    for group in (params, grads, *moments):
        if len(group) != len(params):
            raise ValueError("every gradient and moment list needs one "
                             "tensor a parameter")
        for t, p in zip(group, params):
            if t.dtype != torch.float32 or not t.is_contiguous() \
                    or t.device != dev or t.shape != p.shape:
                raise ValueError(
                    f"the fused optimizer takes contiguous float32 tensors "
                    f"shaped as their parameter on {dev}, got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}"
                )
    for name, t, dtype in scalars:
        if t.device != dev or t.dtype != dtype or t.numel() != 1:
            raise ValueError(f"{name} must be one {dtype} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(kind, params, grads, moments, step_size, c1, c2, bad, *,
            weight_decay: float, momentum: float) -> None:
    global launches
    from mmlspark_tpu_torch.ops.kernel_build import bind, load

    scalars = [("step_size", step_size, torch.float32),
               ("bad", bad, torch.bool)]
    if c1 is not None:
        scalars += [("c1", c1, torch.float32), ("c2", c2, torch.float32)]
    _check(kind, params, grads, moments, scalars)
    lib = bind(load("fused_optim"))
    n = len(params)

    def table(tensors):
        if tensors is None:
            return None
        return (ctypes.c_void_p * n)(*(t.data_ptr() for t in tensors))

    numel = (ctypes.c_longlong * n)(*(p.numel() for p in params))
    dev = params[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mml_fused_optim(
            KINDS.index(kind), n, table(params), table(grads),
            table(moments[0] if moments else None),
            table(moments[1] if len(moments) > 1 else None), numel,
            step_size.data_ptr(), c1.data_ptr() if c1 is not None else None,
            c2.data_ptr() if c2 is not None else None, bad.data_ptr(),
            1 - ADAM_B1, ADAM_B1, 1 - ADAM_B2, ADAM_B2, ADAM_EPS,
            weight_decay, momentum, stream,
        )
    if rc:
        raise RuntimeError(
            f"fused optimizer kernel launch failed: CUDA error {rc} "
            f"({lib.mml_cuda_error_string(rc).decode()})"
        )
    launches += -(-n // MAX_TENSORS)
