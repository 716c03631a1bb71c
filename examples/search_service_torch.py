"""Evolution-as-a-service on the PyTorch/CUDA port: one shared worker fleet,
many search jobs.

Starts a long-lived SearchFrontier, spawns localhost socket workers that
score on the card (or on the CPU with ``--device cpu``, a rehearsal on the
kernel's plain PyTorch version), and submits concurrent SearchJobs over the
wire with a FrontierClient: a high-priority decode search and a
low-priority generalist sweep contending for the same evaluation slots
under weighted-fair scheduling (priority x remaining budget).  Events
stream back live: lineage commits, budget spend, best scores, completion.
On the card every gate runs the kernel's fp32 body in a worker, one locked
section at a time.

  PYTHONPATH=src python examples/search_service_torch.py
  PYTHONPATH=src python examples/search_service_torch.py --device cpu --steps 2

Extra worker capacity joins from any host with
``python -m repro_torch.core.evals.service_worker --connect SERVICE:PORT``.
"""
import argparse
import threading

from repro_torch.core import FrontierClient, SearchFrontier, SearchJob


def stream_job(client, job, tag):
    job_id = client.submit(job)
    print(f"[{tag}] accepted as {job_id} (priority {job.priority}, "
          f"budget {job.budget})")
    for ev in client.stream(job_id):
        if ev.kind == "commit":
            print(f"[{tag}] {ev.t:6.1f}s commit on island "
                  f"{ev.data.get('island')}: geomean "
                  f"{ev.data.get('geomean', 0):.3f}")
        elif ev.kind == "progress":
            print(f"[{tag}] {ev.t:6.1f}s step {ev.data['steps_done']}, "
                  f"spent {ev.data['spent']}/{ev.data['budget']}")
        elif ev.kind in ("done", "cancelled", "failed"):
            print(f"[{tag}] {ev.kind}: {ev.data.get('steps', '?')} steps, "
                  f"{ev.data.get('spent', '?')} paid evals, best geomean "
                  f"{ev.data.get('best_geomean', 0):.3f}"
                  + (f" ({ev.data['error']})" if "error" in ev.data else ""))
    return job_id


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--listen", default="127.0.0.1:0",
                    help="host:port the frontier (workers AND clients) binds")
    ap.add_argument("--workers", type=int, default=2,
                    help="localhost socket workers to spawn into the fleet")
    ap.add_argument("--steps", type=int, default=8,
                    help="archipelago steps per job")
    ap.add_argument("--budget", type=int, default=300,
                    help="paid-evaluation budget per job")
    ap.add_argument("--device", default=None,
                    help="where the workers and jobs score (default: the card; "
                         "'cpu' rehearses on the plain PyTorch version)")
    args = ap.parse_args(argv)

    frontier = SearchFrontier(listen=args.listen, workers=args.workers,
                              device=args.device)
    host, port = frontier.address
    print(f"frontier up at {host}:{port} with "
          f"{frontier.coordinator.total_slots} evaluation slots\n")
    try:
        jobs = [
            ("decode", SearchJob(suite="decode", priority=3.0, budget=args.budget,
                                 steps=args.steps, seed=0, device=args.device)),
            ("sweep", SearchJob(suite="mha+gqa+decode", priority=1.0,
                                budget=args.budget, steps=args.steps, seed=1,
                                device=args.device)),
        ]
        # one client connection is single-reader: one connection per
        # concurrently-streamed job keeps the streams independent
        clients = [FrontierClient(frontier.address) for _ in jobs]
        try:
            threads = [threading.Thread(target=stream_job, args=(c, job, tag))
                       for c, (tag, job) in zip(clients, jobs)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            for c in clients:
                c.close()

        st = frontier.stats()
        print("\nper-tenant slot grants (weighted fair):")
        for tid, t in sorted(st["coordinator"]["tenants"].items()):
            print(f"  {tid}: {t['granted']} granted "
                  f"({t['granted_contended']} contended), "
                  f"{t['completed']} completed")
        return st
    finally:
        frontier.close()


if __name__ == "__main__":
    main()
