"""``python -m repro_torch.serve``: the eager LM serving loop
(``serve.main.serve_main``)."""
from repro_torch.serve.main import serve_main

if __name__ == "__main__":
    serve_main()
