"""Plain reference of the probe's burn-in pass.

The pass as the probe states it: from a ``torch.Generator`` on the device
seeded with 0, ``1 + depth`` layers of ``(size, size)`` float32 standard
normals drawn one layer at a time and rounded to bfloat16, the weights
(every layer after the first) divided by ``sqrt(size)`` in bfloat16; then
for every weight ``y = carry @ w`` with bfloat16 operands and a float32
result, ``rms = sqrt(mean(y^2) + 1e-6)``, ``carry = bfloat16(y / rms)``;
the outputs are ``sum(float32(carry))`` and the last ``rms``.

Here every product runs in float32 with TF32 off, so each product of two
bfloat16 values is exact and only the sums round. ``lower`` names the
precision the operands and the carry are rounded to instead: ``bfloat16``
is the probe's, ``float8_e4m3fn`` the control one step below it. Imports
nothing of the program.
"""

import math

import torch

EPS = 1e-6


def inputs(size: int, depth: int, device) -> tuple:
    """The pass's inputs, drawn again as stated: ``(x, ws)`` in bfloat16."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    layers = torch.empty((1 + depth, size, size), dtype=torch.bfloat16, device=device)
    scratch = torch.empty((size, size), dtype=torch.float32, device=device)
    for layer in layers:
        layer.copy_(scratch.normal_(generator=gen))
    x, ws = layers[0], layers[1:]
    scale = torch.tensor(math.sqrt(size), dtype=torch.float32, device=device)
    ws.div_(scale.to(torch.bfloat16))
    return x, ws


def run(x: torch.Tensor, ws: torch.Tensor, lower=torch.bfloat16) -> dict:
    """The chain over ``x`` and ``ws`` in float32 with TF32 off, operands
    and carry rounded to ``lower``. Returns the checksum, the last rms and
    the L2 norm of the final carry (the checksum's natural scale)."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        carry = x.to(lower).float()
        rms = torch.zeros((), dtype=torch.float32, device=x.device)
        for w in ws:
            y = carry @ w.to(lower).float()
            rms = torch.sqrt(torch.mean(torch.square(y)) + EPS)
            carry = (y / rms).to(lower).float()
        return {
            "checksum": float(carry.sum()),
            "rms": float(rms),
            "norm": float(torch.linalg.vector_norm(carry)),
        }
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def gaps(checksum: float, rms: float, ref: dict) -> dict:
    """How far a pass's outputs lie from the reference's: the checksum's
    distance over the final carry's norm, the rms's over the rms."""
    return {
        "checksum_gap": abs(checksum - ref["checksum"]) / ref["norm"],
        "rms_gap": abs(rms - ref["rms"]) / ref["rms"],
    }
