"""The MULTITHREADED host-path shuffle: tudo serializer, shuffle files
and the exchange exec over them."""
