"""Runtime of the port: serving (`serve_loop`) and training (`train_loop`)."""
