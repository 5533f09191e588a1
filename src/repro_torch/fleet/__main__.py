"""``python -m repro_torch.fleet`` — run one fleet worker process.

(The dispatcher spawns these; see ``repro_torch.fleet.launch_fleet``. A
dedicated ``__main__`` avoids runpy re-executing ``worker`` after the
package import already loaded it.)
"""
from repro_torch.fleet.worker import main

if __name__ == "__main__":
    main()
