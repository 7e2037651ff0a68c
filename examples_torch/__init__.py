"""The example programs of ``examples/``, on the PyTorch/CUDA port
(``algoplonk_tpu_torch``): each compiles its circuit, writes its PuyaPy
verifier, proves, exports the AVM blobs and runs the emitted verifier
offline under the port's AVM mock (``chain/algopy_mock.py``).

    python3 examples_torch/basic/logicsig_verifier.py        # on the card
    python3 -c 'from examples_torch.basic import logicsig_verifier as ex; print(ex.main(device="cpu"))'

Each example's ``main(device=None, outdir=None)`` proves on the CUDA device
unless ``device="cpu"`` is passed, writes into its folder's ``generated/``
unless ``outdir`` is given, and returns what ``offline.run_emitted``
reports.  Run as a script, an example exits 1 when its verifier rejects.
The modules form a package so that the two ``logicsig_verifier`` siblings
can be imported into one process (each smart-contract variant takes its
circuit from its sibling by the package path).
"""
