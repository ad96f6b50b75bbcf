"""The workers' entry point, light to import: the parent names it as the
target of each worker process without loading torch itself."""


def main(conn, spec: dict) -> None:
    from harness import worker

    worker.main(conn, spec)
