"""The launcher's tools over the port: the counterparts of the repo
scripts the JAX package's CLI launches (``tools/docgen.py`` and the
evidence tools under ``tools/``).

- :mod:`.docgen`: the API reference (.rst and static HTML) from the
  port's stage and model registries;
- :mod:`.flash_evidence`: the flash attention kernels, forward and
  gradients, at S=2048 and S=8192 on the card;
- :mod:`.decode_evidence`: KV-cache decode against the recompute oracle;
- :mod:`.profile_resnet50`: a ``torch.profiler`` trace of the ResNet-50
  forward that ``TPUModel`` replays;
- :mod:`.feed_overhead`: ``TPUModel``'s feed machinery against the
  model-only ceiling;
- :mod:`.make_notebooks`: the notebook tier (``notebooks/samples_torch/``)
  from the port's example scripts (``mmlspark_tpu_torch/examples/``).

Each evidence tool has ``run(...)`` returning its record as a dict, a
pure ``check_record(record)`` returning the list of its contract's
violations, and ``main(argv)``: a record is written only when that list
is empty; otherwise it is printed and the tool exits 3. They run on the
card unless ``--device cpu`` is given; without a card they raise naming
the missing CUDA device. :mod:`.timing` is the device timer they share
with ``chip_smoke.py``'s kernel table.
"""
