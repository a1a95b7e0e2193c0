"""Traffic kinds: ``kinds/<kind>.py`` drives a traffic file whose ``kind``
names it, through its ``Driver`` (``setup``, ``window``, ``release``,
``judge``)."""
