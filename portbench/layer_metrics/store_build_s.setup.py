"""``cli.build_store`` in set-up (``trainer.encode_corpus`` and the index
build), synchronised, s."""


def read(run):
    return run.facts.get("store_build_s")
