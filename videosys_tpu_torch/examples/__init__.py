"""Entry points of the port: the inference samples, the PAB experiments and
the CogVideoX gradio demo, counterparts of the repo's `examples/` and
`gradio/` scripts. Each runs on the card unless `device="cpu"` is given."""
