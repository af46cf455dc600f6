#!/usr/bin/env python3
"""Where the port's ResNet-50 recipe step loses time to its input.

The recipe's train step (``recipes/resnet50_imagenet``: ResNet-50 under
``Policy.train()`` in ``DataParallel`` at world size 1, uint8 images
normalized and flipped on the card, SGD with Nesterov momentum, label
smoothing 0.1, L2 1e-4), fed three ways, in turns (each feed twice,
mirrored order), each for ``--steps`` steps after a warm-up:

* ``synthetic``: ``SyntheticImageDataset`` through the prefetching
  ``DataLoader`` (the recipe's feed: its producer thread draws every
  image with numpy, under the interpreter lock);
* ``array``: the same images drawn once up front into an
  ``ArrayDataset``, through the same loader (its producer only gathers
  and pins);
* ``placed``: one batch already on the card, fed again every step.

Per run: wall ms per step (ending in a value fetch), the host's enqueue
per step (the ``train.step`` span), the share of the loop spent in
``train.data_wait``, and images/s; then the card's name and power limit.

    python3 scripts/port_resnet_ingest.py [--batch 128] [--steps 20]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("port_resnet_ingest: no CUDA device", file=sys.stderr)
        return 2
    from pytorch_distributed_tpu_torch import (
        ArrayDataset,
        DataLoader,
        DataParallel,
        Policy,
        ResNet50,
        SyntheticImageDataset,
        Trainer,
        TrainerConfig,
        TrainState,
        build_train_step,
        classification_loss_fn,
        destroy_process_group,
        device_normalizer_for,
        init_process_group,
        optim,
    )
    from pytorch_distributed_tpu_torch.recipes.resnet50_imagenet import (
        MEAN,
        STD,
    )
    from pytorch_distributed_tpu_torch.runtime import tracing
    from pytorch_distributed_tpu_torch.runtime.device import device_info

    torch.backends.cudnn.benchmark = True
    device = torch.device("cuda", 0)
    B, S, n = args.batch, args.steps, args.batch * args.steps
    init_process_group(device=device)
    try:
        model = ResNet50(device=device, policy=Policy.train())
        model.init_weights(
            torch.Generator(device=device).manual_seed(args.seed))
        strategy = DataParallel(device)
        ddp = strategy.wrap(model)
        state = TrainState(ddp, optim.SGD(model, lr=0.05, momentum=0.9,
                                          nesterov=True))
        step = build_train_step(
            classification_loss_fn(ddp, label_smoothing=0.1,
                                   weight_decay=1e-4),
            batch_transform=device_normalizer_for(MEAN, STD, flip=True))
        synthetic = SyntheticImageDataset(n=n, image_shape=(224, 224, 3),
                                          num_classes=1000, seed=args.seed,
                                          dtype=np.uint8)
        items = [synthetic[i] for i in range(n)]
        array = ArrayDataset(
            image=np.stack([it["image"] for it in items]),
            label=np.stack([it["label"] for it in items]))
        placed = {k: torch.from_numpy(v[:B]).to(device)
                  for k, v in array.arrays.items()}

        class Placed:
            def set_epoch(self, epoch):
                pass

            def __iter__(self):
                return iter([placed] * S)

        feeds = {
            "synthetic": lambda: DataLoader(synthetic, B, seed=args.seed,
                                            sharding=device),
            "array": lambda: DataLoader(array, B, seed=args.seed,
                                        sharding=device),
            "placed": Placed,
        }

        def run(feed):
            with tracing.enabled() as tracer:
                trainer = Trainer(state, step, feeds[feed](),
                                  config=TrainerConfig(
                                      log_every=S, max_steps_per_epoch=S))
                trainer.fit()
            roll = tracer.rollups()
            step_ms = 1e3 * trainer.history[-1]["step_time_s"]
            return dict(step_ms=step_ms, images_per_s=B / step_ms * 1e3,
                        host_enqueue_ms=roll["train.step"]["mean_ms"],
                        data_wait_share=roll["train.data_wait"]["total_ms"]
                        / (S * step_ms))

        run("placed")   # warm-up: cuDNN's autotuning, the allocator
        out = {}
        for feed in ("synthetic", "array", "placed", "placed", "array",
                     "synthetic"):
            r = run(feed)
            out.setdefault(feed, []).append(r)
            print(f"{feed:9s} step {r['step_ms']:8.2f} ms  "
                  f"{r['images_per_s']:8.1f} images/s  host enqueue "
                  f"{r['host_enqueue_ms']:7.2f} ms  data_wait "
                  f"{100 * r['data_wait_share']:5.2f}%", flush=True)
    finally:
        destroy_process_group()
    print(json.dumps({"port_resnet_ingest": out, "batch": B, "steps": S}))
    print(device_info())
    return 0


if __name__ == "__main__":
    sys.exit(main())
