"""One rank of a world that `multihost.spawn` started:

    python -m ppq_tpu_torch.parallel._rank WORKDIR

with RANK, WORLD_SIZE and PPQ_TPU_STORE in the environment. It joins the
world, imports the job's function, runs it and writes its result to
WORKDIR/result<RANK>.pkl; a failure exits non-zero with its traceback."""

import importlib
import os
import pickle
import sys
import traceback


def main(work: str) -> int:
    with open(os.path.join(work, 'job.pkl'), 'rb') as f:
        job = pickle.load(f)
    rank = int(os.environ['RANK'])
    import torch
    import torch.distributed as dist

    from .multihost import initialize_multihost
    torch.set_num_threads(1)
    if job['root'] not in sys.path:
        sys.path.insert(0, job['root'])
    try:
        initialize_multihost(device=job['device'], timeout=job['timeout'])
        fn = importlib.import_module(job['module'])
        for part in job['qualname'].split('.'):
            fn = getattr(fn, part)
        result = fn(*job['args'])
        tmp = os.path.join(work, f'result{rank}.tmp')
        with open(tmp, 'wb') as f:
            pickle.dump(result, f)
        os.replace(tmp, os.path.join(work, f'result{rank}.pkl'))
        if dist.is_initialized():
            # no rank leaves while another may still talk to it
            dist.barrier()
            dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        # exit at once: a clean shutdown could wait on a peer's collective
        os._exit(1)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1]))
