"""One rank of a gloo job on the CPU that runs the port's `sharded_hmc`
(imported by no test; tests/test_torch_chains.py starts it as a process):

    python tests/torch_ranks.py RANK WORLD INIT_FILE OUT_DIR

It joins the job through a `file://` rendezvous, runs `sharded_hmc` on
configuration #5's model at n = 12 (f64) once through, then again with a
checkpoint after 8 iterations, stopped there and resumed from the file
that rank 0 wrote, and saves what rank 0 sees, with both ranks' pod-mesh
layouts, to OUT_DIR/rank{RANK}.npz.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from gaussianprocesses_jl_tpu_torch.parallel import chains, mesh  # noqa: E402
from gaussianprocesses_jl_tpu_torch.perf import student_t_study  # noqa: E402

HMC_KW = dict(n_iter=8, n_warmup=24, eps0=0.05, Lmin=2, Lmax=5)
C, N_OBS, SEED = 4, 12, 3


def problem():
    """(logprob, theta0 (C, D)) of the runs, the same in every process."""
    logprob, x0, _, _ = student_t_study.config5_model("cpu", np.float64, N_OBS).make_logprob()
    return logprob, x0 + 0.05 * torch.as_tensor(np.random.RandomState(0).randn(C, x0.numel()))


def interrupted(logprob, theta0, m, path):
    """A checkpointed run stopped on every rank after its first write."""
    save = chains._save_state

    def stop(*args):
        save(*args)
        raise KeyboardInterrupt

    chains._save_state = stop
    try:
        chains.sharded_hmc(logprob, theta0, SEED, m, checkpoint_every=8, checkpoint_path=path,
                           **HMC_KW)
    except KeyboardInterrupt:
        return
    finally:
        chains._save_state = save
    raise AssertionError("the run was not stopped at its checkpoint")


def main(rank, world, init_file, out_dir):
    torch.set_num_threads(1)  # the ranks share the machine's cores
    mesh.initialize_distributed(f"file://{init_file}", world, rank)
    try:
        m = mesh.make_mesh(device="cpu")
        logprob, theta0 = problem()
        whole = chains.sharded_hmc(logprob, theta0, SEED, m, **HMC_KW)
        path = os.path.join(out_dir, "hmc.ckpt.npz")
        interrupted(logprob, theta0, m, path)
        resumed = chains.sharded_hmc(logprob, theta0, SEED, m, checkpoint_every=8,
                                     checkpoint_path=path, **HMC_KW)
        pods = {}
        for inner in (1, 2):
            pm = mesh.make_pod_mesh({"j": inner}, device="cpu")
            pods[f"pod{inner}_shape"] = np.asarray([pm.shape["chains"], pm.shape["j"]])
            pods[f"pod{inner}_coords"] = np.asarray([pm.coords["chains"], pm.coords["j"]])
        out = {f"{name}_{f}": getattr(res, f).numpy()
               for name, res in (("whole", whole), ("resumed", resumed))
               for f in ("samples", "accept_rate", "eps_final", "minv_final", "final",
                         "final_target")}
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out, **pods)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
