"""Instance generators, one file per instance class. Each module has
``generate(seed, **args) -> reference.instance.Instance``; a
configuration names its module and arguments
(``configs/<config>.json``)."""
