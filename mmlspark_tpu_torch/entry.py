"""The port's entry point — the twin of ``__graft_entry__.py``'s
``entry()`` at the repo root.

``entry()`` returns a forward step on the flagship model (ResNet-20 for
CIFAR-10, the reference notebook-301 eval model) with its example
arguments, on the card unless the caller asks for the CPU. The JAX
module's ``dryrun_multichip`` — full training steps over an n-device
mesh — waits with the trainer's mesh mode (the rest of ROADMAP.md Queue 1
item 13).
"""

from __future__ import annotations

import torch


def entry(device=None):
    """Return ``(forward, (variables, example_x))`` for ResNet-20: the
    port's seeded variables (seed 0) and a zero batch of 128 NHWC 32x32
    RGB images, both on ``device``; ``forward(variables, x)`` returns the
    (128, 10) f32 logits."""
    from mmlspark_tpu_torch.core.env import default_device
    from mmlspark_tpu_torch.models import build_model, init_variables

    dev = default_device(device)
    graph = build_model("resnet20_cifar10")
    variables = init_variables(graph, 0, device=dev)

    def forward(variables, x):
        return graph.apply(variables, x)

    example_x = torch.zeros((128, 32, 32, 3), dtype=torch.float32,
                            device=dev)
    return forward, (variables, example_x)
