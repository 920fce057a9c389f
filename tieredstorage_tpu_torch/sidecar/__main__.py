from tieredstorage_tpu_torch.sidecar.server import main

if __name__ == "__main__":
    main()
