"""CLI entry: ``python -m graphsage_torch.train --preset cora --data-root cora``.

The port's counterpart of ``python -m graphsage_tpu.train`` (see
:func:`graphsage_torch.train.experiments.main`); ``--device cpu`` trains on
the CPU.
"""

from graphsage_torch.train.experiments import main

if __name__ == "__main__":
    main()
