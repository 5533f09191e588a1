"""Step factories, the trainer and the serving front (port of
``repro.launch``): ``train`` (the AdamW and NGD train steps, score pass,
prefill, greedy serve step), ``trainer`` (``build_trainer``,
``train_main``, ``ServeHandles``, ``build_server``, ``build_fleet``),
``supervisor`` (the checkpoint/restart loop), and ``mesh`` (device
meshes and their collectives, driven from one process). Shardings and
the dry-run come with the launch tooling (``repro_torch.roadmap``)."""
