"""Step factories, the trainer and the serving front (port of
``repro.launch``): ``train`` (the AdamW and NGD train steps, score pass,
prefill, greedy serve step), ``trainer`` (``build_trainer``,
``train_main``, ``ServeHandles``, ``build_server``, ``build_fleet``),
``supervisor`` (the checkpoint/restart loop), ``mesh`` (device meshes
and their collectives, driven from one process), ``shardings`` (the
parameter, input and cache layout rules as data), ``hlo_analysis`` (the
HLO text parsers and the H100's roofline) and ``dryrun`` (every cell's
step traced on meta tensors: memory, cost, collectives)."""
