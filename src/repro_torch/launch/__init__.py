"""Step factories and the serving front (port of ``repro.launch``):
``train`` (score pass, prefill, greedy serve step) and ``trainer``
(``ServeHandles``, ``build_server``). The training loop, meshes,
shardings, the supervisor and the dry-run come with later slices."""
