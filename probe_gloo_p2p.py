"""Does gloo take CUDA tensors in point-to-point calls? Two ranks on
cuda:0 joined over gloo, as chip_smoke.py's phases 29 and 31 run them:
first an all-gather of a CUDA tensor (what the port's halo exchange
uses), then dist.send / dist.recv of one. Prints one line for each, and
a rank that the backend aborts is reported as such.

    python3 probe_gloo_p2p.py      # on a machine with a CUDA card
"""

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _gather(rank, port):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    t = torch.full((4,), float(rank), device="cuda")
    out = torch.empty(8, device="cuda")
    dist.all_gather_into_tensor(out, t)
    if rank == 0:
        print(f"gloo all_gather_into_tensor of a CUDA tensor: {out.tolist()}", flush=True)
    dist.destroy_process_group()


def _p2p(rank, port):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    t = torch.full((4,), float(rank), device="cuda")
    if rank == 0:
        dist.send(t, 1)
    else:
        dist.recv(t, 0)
        print(f"gloo send/recv of a CUDA tensor: rank 1 got {t.tolist()}", flush=True)
    dist.destroy_process_group()


def main() -> None:
    from mgtpu_torch.main import free_port

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    for what, fn in (("all_gather_into_tensor", _gather), ("send/recv", _p2p)):
        try:
            mp.start_processes(fn, args=(free_port(),), nprocs=2, start_method="spawn")
        except Exception as e:  # a rank the backend aborted, or an error it raised
            print(f"gloo {what} of a CUDA tensor: refused ({type(e).__name__}: "
                  f"{str(e).splitlines()[0]})", flush=True)


if __name__ == "__main__":
    main()
