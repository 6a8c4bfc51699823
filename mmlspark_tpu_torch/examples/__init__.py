"""The sample workflows over the port: the twelve examples of the JAX
package's ``examples/`` (ten mirror the reference's sample notebooks
101-305; e306 and e307 are the long-context and generation samples),
each run through ``python -m mmlspark_tpu_torch run <script>`` on the
card, or with ``--cpu-mesh N`` on the CPU; :mod:`.harness` runs them
all, one process each. ``README.md`` beside them says which reference
notebook each mirrors."""
