"""A dead-peer pair for the port's watchdog test
(tests/test_torch_port_watchdog.py), the counterpart of
``tests/_chaos_hang_worker.py``: two roles sharing one heartbeat directory,
run as separate processes, with the port's modules alone.

- role 0, the survivor: arms the heartbeat and the watchdog through
  ``watchdog.start`` (what ``parallel/spawn.py`` arms beside a rendezvous)
  and idles as a process waiting in a collective would; its watchdog must
  find the peer's stale beat and ``os._exit(76)``;
- role 1, the dead peer: beats until ``$TPUDDP_FAULT=hang@barrier`` fires
  on entry to ``collectives.barrier``, which stops its beat and sleeps for
  ever.

Usage: python _torch_port_hang_worker.py <process_id> <num_processes> <shared_dir>
(``$TPUDDP_WATCHDOG_TIMEOUT`` set; role 1 also needs ``$TPUDDP_FAULT``).
"""

import sys
import time

from tpuddp_torch.parallel import collectives
from tpuddp_torch.resilience import watchdog

pid, nprocs, shared = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
pair = watchdog.start(shared, pid, nprocs, interval=0.25)
assert pair is not None, "watchdog not armed: $TPUDDP_WATCHDOG_TIMEOUT unset?"
print(f"WORKER {pid} armed", flush=True)

if pid == 1:
    # the peer's first beat first, so the test measures the stale verdict,
    # not the startup grace
    directory = watchdog.heartbeat_dir(shared)
    deadline = time.time() + 60.0
    while watchdog.read_heartbeat(directory, 0) is None:
        assert time.time() < deadline, "peer 0 never started heartbeating"
        time.sleep(0.05)
    collectives.barrier()  # hang@barrier fires here and never returns
    print("UNREACHABLE: the hang fault did not fire", flush=True)
    sys.exit(1)

while True:  # only the watchdog's exit(76) ends the survivor
    time.sleep(0.25)
