"""Helpers of the data-parallel tests: a free port, and one rank of the
world-2 train step.

    python tests/torch_ranks.py RANK WORLD PORT DIR

joins a gloo group of WORLD processes at 127.0.0.1:PORT, reads
``DIR/inputs.pt`` (``state_dict``, ``images`` [B, H, W, 3] normalized,
``targets`` [B, M, 5], ``lr``, ``weight_decay``), starts from rank 0's
weights (the other ranks draw others, which the broadcast replaces),
takes one step of ``train.make_train_step`` on its B / WORLD rows and
writes the reduced gradients, the parameters after the step and the
two losses to ``DIR/rank{RANK}.pt``.
"""

import datetime
import os
import socket
import sys

import torch

TIMEOUT = datetime.timedelta(seconds=120)


def free_port():
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def step_rank(rank, world, port, workdir):
    import torch.distributed as dist

    from odtk_tpu_torch import parallel
    from odtk_tpu_torch import train as port_train
    from odtk_tpu_torch.model import Model

    torch.set_num_threads(1)
    parallel.init_distributed(f'127.0.0.1:{port}', world, rank, device='cpu',
                              timeout=TIMEOUT)
    try:
        inputs = torch.load(os.path.join(workdir, 'inputs.pt'))
        model = Model('ResNet18FPN', classes=inputs['classes'])
        if rank == 0:
            model.module.load_state_dict(inputs['state_dict'], strict=True)
        else:
            model.initialize(rank)
        parallel.broadcast_from_rank0([*model.module.parameters(),
                                       *model.module.buffers()])
        opt = port_train.make_optimizer(model.module.parameters(),
                                        inputs['lr'], inputs['weight_decay'])
        step = port_train.make_train_step(model, opt, feed='f32')
        per = len(inputs['images']) // world
        rows = slice(rank * per, (rank + 1) * per)
        cl, bl = step(inputs['lr'], inputs['images'][rows],
                      inputs['targets'][rows])
        named = dict(model.module.named_parameters())
        torch.save({'loss': [cl.item(), bl.item()],
                    'grads': {k: p.grad for k, p in named.items()},
                    'params': {k: p.detach() for k, p in named.items()},
                    'skipped': opt.found_inf.item()},
                   os.path.join(workdir, f'rank{rank}.pt'))
    finally:
        dist.destroy_process_group()


if __name__ == '__main__':
    step_rank(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
              sys.argv[4])
