"""Step factories, the trainer and the serving front (port of
``repro.launch``): ``train`` (the AdamW and NGD train steps, score pass,
prefill, greedy serve step), ``trainer`` (``build_trainer``,
``train_main``, ``ServeHandles``, ``build_server``) and ``supervisor``
(the checkpoint/restart loop). Meshes, shardings and the dry-run come
with the launch tooling (``repro_torch.roadmap``)."""
