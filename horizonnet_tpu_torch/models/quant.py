"""Post-training int8 quantization of the resnet encoder for serving.

Counterpart of horizonnet_tpu/models/quant.py::quantize_variables on the
port's state_dict: every encoder Conv+BN pair becomes the buffers of one
models/layers.py::QuantConvBN at the conv's name,

- ``weight_q``: int8 [out, in/groups, kh, kw], symmetric per output
  channel: the BN-folded kernel ``W * gamma / sqrt(var + eps)`` rounded
  to its per-channel step,
- ``scale``: f32 [out], that step (the dequantization factor),
- ``bias``: f32 [out], the folded BN shift ``beta - mean * gamma/sigma``.

The fold is JAX's float64 numpy, copied, so the results are JAX's bit for
bit. The height stage, the LSTM and the head pass through. This is a
one-way serving-time transform: checkpoints on disk stay float.
"""

import numpy as np
import torch

ENCODER = "feature_extractor.encoder."
# conv module name -> its batch norm sibling in one block or the stem
_PAIR = {"conv1": "bn1", "conv2": "bn2", "conv3": "bn3"}
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var",
              "num_batches_tracked")


def _bn_of(conv):
    """A conv module's path (without the LR_PAD ``.1``) -> its batch
    norm's path."""
    head, _, name = conv.rpartition(".")
    if name in _PAIR:
        return f"{head}.{_PAIR[name]}"
    if name == "0" and head.endswith(".downsample"):
        return f"{head}.1"
    raise KeyError(f"{conv}: no batch norm pairs with this conv (int8 "
                   "serving covers the resnet family)")


def _fold_quantize(weight, gamma, beta, mean, var, eps):
    """OIHW float kernel and its batch norm -> (weight_q, scale, bias),
    in float64 as horizonnet_tpu/models/quant.py::_fold_quantize."""
    f64 = lambda t: t.detach().cpu().double().numpy()  # noqa: E731
    w = f64(weight)
    g = f64(gamma) / np.sqrt(f64(var) + eps)
    bias = f64(beta) - f64(mean) * g
    wf = w * g[:, None, None, None]             # fold gamma/sigma per oc
    step = np.abs(wf).max(axis=(1, 2, 3))
    step = np.maximum(step, 1e-12) / 127.0
    kq = np.clip(np.rint(wf / step[:, None, None, None]), -127, 127)
    return (torch.from_numpy(kq.astype(np.int8)),
            torch.from_numpy(step.astype(np.float32)),
            torch.from_numpy(bias.astype(np.float32)))


def quantize_state_dict(state_dict, eps=1e-5):
    """A float port state_dict -> the state_dict of the quant_int8 model.

    The encoder's convs become QuantConvBN buffers and their batch norms
    drop out; every other entry passes through. ``eps`` is the batch
    norm epsilon the weights were trained with (1e-5)."""
    out, folded = {}, set()
    for key, t in state_dict.items():
        if not (key.startswith(ENCODER) and key.endswith(".weight")
                and t.dim() == 4):
            continue
        conv = key[:-len(".weight")]
        if conv.endswith(".1"):
            conv = conv[:-2]
        bn = _bn_of(conv)
        out[f"{conv}.weight_q"], out[f"{conv}.scale"], out[f"{conv}.bias"] = (
            _fold_quantize(t, *(state_dict[f"{bn}.{leaf}"] for leaf in
                                _BN_LEAVES[:4]), eps))
        folded.add(key)
        folded.update(f"{bn}.{leaf}" for leaf in _BN_LEAVES)
    if not folded:
        raise KeyError("no encoder conv in the state_dict")
    for key, t in state_dict.items():
        if key not in folded:
            if key.startswith(ENCODER):
                raise KeyError(f"{key}: an encoder entry that is neither a "
                               "conv nor its batch norm")
            out[key] = t
    return out
