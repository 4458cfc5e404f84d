"""Readings behind the bfloat16 tolerances of `tests/test_torch_conv.py`.

For `lenet_digits` (batch 8) and the narrowed `alexnet_cifar10` of the
tests (batch 2), over seeded batches on the CPU: the port's loss and
gradients in bf16 compute against the JAX package's in bf16 (the sound
error), and the JAX package's bf16 against its own float32 (the error of
a computation in a lower precision).  Gradients are compared all at once
in relative L2 norm (||got - want|| / ||want||), the loss relatively.

    JAX_PLATFORMS=cpu python tools/torch_conv_bf16_readings.py [seeds]
"""

import dataclasses
import os
import sys

import numpy as np

sys.path[:0] = [os.path.join(os.path.dirname(__file__), "..", "tests"),
                os.path.join(os.path.dirname(__file__), "..")]

import test_torch_conv as T  # noqa: E402


def _with_dtype(conf, dtype):
    return dataclasses.replace(conf, conf=dataclasses.replace(
        conf.conf, compute_dtype=dtype))


def _flat(grads):
    import torch

    return [np.asarray(g[k].float().numpy() if torch.is_tensor(g[k])
                       else g[k], np.float32)
            for g in grads for k in sorted(g)]


def main(seeds: int = 12) -> None:
    import torch

    worst = {}
    for name, (make, shape) in sorted(T.NETS.items()):
        jb, tb = T.pair(_with_dtype(make(), "bfloat16"))
        jf, _ = T.pair(_with_dtype(make(), "float32"))
        for seed in range(seeds):
            x, y = T._batch(shape, seed=seed)
            lb, gb = T._jax_loss_and_grads(jb, x, y)
            lf, gf = T._jax_loss_and_grads(jf, x, y)
            loss, _ = tb._objective(tb.params, tb.state, torch.from_numpy(x),
                                    torch.from_numpy(y), None)
            got = tb._grads(loss)
            row = {"sound_loss": T._rel(loss.item(), lb),
                   "sound_grads": T._l2(_flat(got), _flat(gb)),
                   "lower_loss": T._rel(lb, lf),
                   "lower_grads": T._l2(_flat(gb), _flat(gf))}
            print(name, seed, " ".join(f"{k} {v:.3g}"
                                       for k, v in row.items()), flush=True)
            for k, v in row.items():
                pick = max if k.startswith("sound") else min
                worst[k] = pick(worst.get(k, v), v)
    print("largest sound: loss {sound_loss:.3g}, gradients {sound_grads:.3g};"
          " smallest lower-precision: loss {lower_loss:.3g}, gradients "
          "{lower_grads:.3g}".format(**worst))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 12)
