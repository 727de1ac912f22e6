"""The JAX package's ``examples/01``-``08`` on the port, one module each.

Run one with ``python -m graphsage_torch.examples.01_train_cora`` from the
root of the checkout (``--device cpu`` for the CPU; the card is the
default); each module's ``main(argv)`` runs it in-process. ``03`` and ``05``
form a world of one when no process group exists (NCCL on the card, gloo
on the CPU), or join the one ``torchrun`` describes.
"""
