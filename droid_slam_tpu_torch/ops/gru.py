"""The ConvGRU's two gate epilogues, as plain PyTorch.

Counterpart of ``droid_slam_tpu/ops/gru_pallas.py:40-60`` in the port's NCHW
layout. These are the plain twins of the CUDA kernels in
``csrc/gru_epilogue.cu`` (wrapper: ``ops/gru_cuda.py``) and mirror their
precision exactly: every operand is cast to f32, the four terms are summed in
the JAX order (conv + corr/flow slice + context precompute + gate bias), the
activations run in f32, and each output is rounded once to ``net.dtype``.

Shapes: ``[E,C,h,w]`` planes, per-edge gate biases ``[E,C]``. ``cf`` is the
merged corr/flow conv output ``[E,384,h,w]``: channels ``[0,256)`` feed the
z and r gates, ``[256,384)`` the candidate state q.
"""

from __future__ import annotations

import torch

_F32 = torch.float32


def gru_epilogue_a_plain(zrc, cf, pre_zr, net, gzr):
    """zrc, pre_zr [E,256,h,w]; cf [E,384,h,w]; net [E,128,h,w];
    gzr [E,256] (global-context gates plus the conv bias, pre-summed).
    Returns (z, r*net), each [E,128,h,w] in net.dtype."""
    zr = (zrc.to(_F32) + cf[:, :256].to(_F32) + pre_zr.to(_F32)
          + gzr.to(_F32)[:, :, None, None])
    z = torch.sigmoid(zr[:, :128])
    r = torch.sigmoid(zr[:, 128:])
    return z.to(net.dtype), (r * net.to(_F32)).to(net.dtype)


def gru_epilogue_b_plain(qc, cf, pre_q, net, z, gq):
    """qc, pre_q, net, z [E,128,h,w]; cf [E,384,h,w]; gq [E,128].
    Returns the new hidden state (1-z)*net + z*q [E,128,h,w] in net.dtype."""
    q = torch.tanh(qc.to(_F32) + cf[:, 256:].to(_F32) + pre_q.to(_F32)
                   + gq.to(_F32)[:, :, None, None])
    zf = z.to(_F32)
    return ((1.0 - zf) * net.to(_F32) + zf * q).to(net.dtype)
