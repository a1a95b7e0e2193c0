"""The JAX package's variables -> the port's (the reference's) state_dict.

Exact inverse of horizonnet_tpu/models/torch_convert.py::
torch_state_to_variables (resnet family): conv HWIO -> OIHW, with the
``.1`` infix on width-padded (k > 1) convs; dense kernel [in, out] ->
weight [out, in]; BN scale/bias/mean/var -> weight/bias/running_mean/
running_var (num_batches_tracked 0); LSTM ``l{k}_w_ih/w_hh/b`` [D, ...] ->
``weight_ih_l{k}[_reverse]`` etc. with bias_ih = b and bias_hh = 0.
Every leaf of the variables is consumed; an unknown one raises.
"""

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


class _Writer:
    def __init__(self):
        self.sd = {}

    def conv(self, key, node):
        node = dict(node)
        k = np.asarray(node.pop("kernel"))
        infix = ".1" if k.shape[0] > 1 or k.shape[1] > 1 else ""
        self.sd[f"{key}{infix}.weight"] = _t(k.transpose(3, 2, 0, 1))
        if "bias" in node:
            self.sd[f"{key}{infix}.bias"] = _t(node.pop("bias"))
        if node:
            raise KeyError(f"{key}: unused conv leaves {sorted(node)}")

    def bn(self, key, p, s):
        if set(p) != {"scale", "bias"} or set(s) != {"mean", "var"}:
            raise KeyError(f"{key}: BN leaves {sorted(p)} / {sorted(s)}")
        self.sd[f"{key}.weight"] = _t(p["scale"])
        self.sd[f"{key}.bias"] = _t(p["bias"])
        self.sd[f"{key}.running_mean"] = _t(s["mean"])
        self.sd[f"{key}.running_var"] = _t(s["var"])
        self.sd[f"{key}.num_batches_tracked"] = torch.tensor(0)

    def dense(self, key, node):
        if set(node) != {"kernel", "bias"}:
            raise KeyError(f"{key}: dense leaves {sorted(node)}")
        self.sd[f"{key}.weight"] = _t(np.asarray(node["kernel"]).T)
        self.sd[f"{key}.bias"] = _t(node["bias"])


def _encoder(w, params, stats):
    pre = "feature_extractor.encoder"
    for name, p in params.items():
        s = stats.get(name, {})
        if name == "conv1":
            w.conv(f"{pre}.conv1", p["conv"])
        elif name == "bn1":
            w.bn(f"{pre}.bn1", p["bn"], s["bn"])
        elif name.startswith("layer"):
            li, bi = name[len("layer"):].split("_")
            t = f"{pre}.layer{li}.{bi}"
            for sub, sp in p.items():
                if sub.startswith("conv"):
                    w.conv(f"{t}.{sub}", sp["conv"])
                elif sub.startswith("bn"):
                    w.bn(f"{t}.{sub}", sp["bn"], s[sub]["bn"])
                elif sub == "downsample_conv":
                    w.conv(f"{t}.downsample.0", sp["conv"])
                elif sub == "downsample_bn":
                    w.bn(f"{t}.downsample.1", sp["bn"], s[sub]["bn"])
                else:
                    raise KeyError(f"encoder/{name}/{sub}")
        else:
            raise NotImplementedError(
                f"encoder/{name}: only the float resnet encoders convert "
                "(densenet and int8 trees are ROADMAP Queue 1 item 7)")


def variables_to_state_dict(variables):
    """{'params', 'batch_stats'} of horizonnet_tpu (numpy or jax arrays)
    -> the reference state_dict of CPU float tensors."""
    params = dict(variables["params"])
    stats = variables.get("batch_stats", {})
    w = _Writer()
    _encoder(w, params.pop("encoder"), stats.get("encoder", {}))
    for gi, g in params.pop("height").items():
        i = int(gi[len("ghc"):])
        for cj, c in g.items():
            j = int(cj[len("c"):])
            t = f"reduce_height_module.ghc_lst.{i}.layer.{j}.layers"
            w.conv(f"{t}.0", c["conv"]["conv"])
            w.bn(f"{t}.1", c["bn"]["bn"], stats["height"][gi][cj]["bn"]["bn"])
    if "bi_rnn" in params:
        rnn = dict(params.pop("bi_rnn"))
        for layer in range(len(rnn) // 3):
            w_ih = np.asarray(rnn.pop(f"l{layer}_w_ih"))
            w_hh = np.asarray(rnn.pop(f"l{layer}_w_hh"))
            b = np.asarray(rnn.pop(f"l{layer}_b"))
            for d, sfx in enumerate(("", "_reverse")[:w_ih.shape[0]]):
                w.sd[f"bi_rnn.weight_ih_l{layer}{sfx}"] = _t(w_ih[d])
                w.sd[f"bi_rnn.weight_hh_l{layer}{sfx}"] = _t(w_hh[d])
                w.sd[f"bi_rnn.bias_ih_l{layer}{sfx}"] = _t(b[d])
                w.sd[f"bi_rnn.bias_hh_l{layer}{sfx}"] = torch.zeros(
                    b.shape[-1], dtype=w.sd[f"bi_rnn.bias_ih_l{layer}{sfx}"]
                    .dtype)
        if rnn:
            raise KeyError(f"bi_rnn: unused leaves {sorted(rnn)}")
        w.dense("linear", params.pop("linear"))
    else:
        w.dense("linear.0", params.pop("linear_0"))
        w.dense("linear.3", params.pop("linear_1"))
    if params:
        raise KeyError(f"unused parameter groups {sorted(params)}")
    return w.sd
