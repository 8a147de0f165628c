"""Command-line tools of the port: the local launcher
(``python -m mxnet_tpu_torch.tools.launch``) and the four-card smoke run
(``mxnet_tpu_torch.tools.multigpu_smoke``)."""
